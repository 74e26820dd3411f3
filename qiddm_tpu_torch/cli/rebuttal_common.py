"""The rebuttal drivers' factory (counterpart of
``qiddm_tpu/cli/rebuttal_common.py``; reference src/bloodmnist.py,
src/PneumoniaMNIST.py, src/fruit_360.py, src/logo2kplus.py, clones that
differ in their dataset, labels and save paths).

Each trains ``QDenseUndirected_old_noise 60 <side>`` (the "Qdense"
baseline: ceil(log2(side^2)) wires, depth 60, a CNOT ring; 10 wires at
28x28, 12 at 64x64) and ``QIDDM_LL_noise <side^2> 6 14 2`` on 5 images a
label (``--ds-size 5``), whose training split is augmented to 100 images
by random +-15 degree rotations (src/bloodmnist.py:335-342, :413-460),
for 15 epochs at batch 1, tau 10; then samples 5 iterations and scores
SSIM against the augmented training images. At ``--ds-size 5`` a label
may have no image: the run then raises ``ValueError``, as the JAX
package's does.
"""

from __future__ import annotations

import sys

from . import common


def _default_models(img_size: int):
    pixels = str(img_size * img_size)
    return [
        ["QDenseUndirected_old_noise", "60", str(img_size)],
        ["QIDDM_LL_noise", pixels, "6", "14", "2"],
    ]


def make_main(description, *, default_data, default_img_size, labels,
              save_prefix, n_classes, default_models=None,
              augment_to: int = 100):
    """``(parse_args, main)`` of one rebuttal driver."""
    def parse_args(argv):
        p = common.build_parser(
            description,
            default_models=default_models or _default_models(default_img_size),
            default_data=default_data, default_img_size=default_img_size,
            default_label=labels[0], default_ds_size=5, default_epochs=15,
            default_batch_size=1, default_tau=10,
            default_save_path=save_prefix, default_load_path=save_prefix)
        p.set_defaults(n_classes=n_classes)
        return p.parse_args(argv)

    def main(argv=None):
        common.initial_log()
        args = parse_args(sys.argv[1:] if argv is None else argv)
        return common.run_labels(args, labels=labels, augment_to=augment_to,
                                 tau_test=5,
                                 protocol=common.REBUTTAL_PROTOCOL)

    return parse_args, main
