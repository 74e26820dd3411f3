"""MNIST hardware-noise robustness driver (counterpart of
``qiddm_tpu/cli/mnist_noise.py``, reference src/mnist_noise.py):

    python -m qiddm_tpu_torch.cli.mnist_noise --device cuda

Trains each model clean, then samples under the rotation-angle error
(add_noise=4) at intensities 0.00..0.09 (reference :441-444) and scores
each. Its default data, ``mnist_8x8``, is sklearn's digits dataset.
"""

from __future__ import annotations

import sys

from . import common, noise_common

# reference src/mnist_noise.py:38-52 default model list
DEFAULT_MODELS = [
    ["differN_noise", "8", "4", "2"],
    ["QDenseUndirected_old_noise", "60", "8"],
    ["QIDDM_PL_noise", "64", "4", "2", "1"],
    ["QNN_noise", "64", "4", "2"],
]


def parse_args(argv):
    p = common.build_parser(
        "QDDM noise robustness (MNIST)",
        default_models=DEFAULT_MODELS, default_data="mnist_8x8",
        default_img_size=8, default_label=3, default_ds_size=500,
        default_epochs=30, default_batch_size=1, default_tau=10,
        with_noise_intensity=True,
        default_save_path="results/noise/mnist_",
        default_load_path="results/noise/mnist_")
    return p.parse_args(argv)


def main(argv=None):
    common.initial_log()
    args = parse_args(sys.argv[1:] if argv is None else argv)
    args.label = 0  # reference main loop trains label 0 (src/*_noise.py:360)
    intensities = [0.01 * i for i in range(0, 10)]  # reference :441-444
    return noise_common.run_noise_sweep(
        args, noise_types=range(4, 5), intensities=intensities)


if __name__ == "__main__":
    main()
