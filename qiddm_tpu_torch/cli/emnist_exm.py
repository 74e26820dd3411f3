"""EMNIST-letters experiment driver (counterpart of
``qiddm_tpu/cli/emnist_exm.py``, reference src/emnist_exm.py, a clone of
mnist_exm over the letters split).

    python -m qiddm_tpu_torch.cli.emnist_exm --device cuda

Same flags and defaults as the JAX driver: 26 classes, label 2, both
default models, 5 sampling iterations, and the EMNIST scoring protocol
(one generated image against twenty real ones). It reads EMNIST idx files
or ``$QIDDM_DATA_DIR/emnist_letters_28.npz``, else renders synthetic
letters (PIL and the DejaVu fonts).
"""

from __future__ import annotations

import sys

from . import common

DEFAULT_MODELS = [
    ["QIDDM_LL_noise", "784", "6", "14", "2"],
    ["QNN_noise", "784", "8", "14"],
]


def parse_args(argv):
    p = common.build_parser(
        "Quantum Denoising Diffusion Model (EMNIST letters)",
        default_models=DEFAULT_MODELS, default_data="emnist_28x28",
        default_img_size=28, default_ds_size=500, default_epochs=50,
        default_batch_size=1, default_tau=10,
        default_save_path="results/formal/emnist_",
        default_load_path="results/formal/emnist_")
    p.set_defaults(n_classes=26)
    return p.parse_args(argv)


def main(argv=None):
    common.initial_log()
    args = parse_args(sys.argv[1:] if argv is None else argv)
    return common.run_labels(args, labels=range(2, 3), tau_test=5,
                             protocol=common.EMNIST_PROTOCOL)


if __name__ == "__main__":
    main()
