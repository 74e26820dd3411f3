"""FashionMNIST hardware-noise robustness driver (counterpart of
``qiddm_tpu/cli/fashion_noise.py``, reference src/fashion_noise.py):

    python -m qiddm_tpu_torch.cli.fashion_noise --all-noise-types \
        --device cuda

Intensities [0.1, 0.2, 0.3, 0.5, 0.8] (reference :431-433); noise type 3
only (depolarizing, the reference's ``add_noise in range(3, 4)``,
src/fashion_noise.py:429), or with ``--all-noise-types`` types 1-3 (phase
damping, amplitude damping, depolarizing). The density-matrix backend runs
every type. Its default data, ``fashion_28x28``, reads FashionMNIST idx
files or ``$QIDDM_DATA_DIR/fashion_28.npz``.
"""

from __future__ import annotations

import sys

from . import common, noise_common

# reference src/fashion_noise.py default model list
DEFAULT_MODELS = [
    ["QNN_noise", "784", "8", "6"],
]


def parse_args(argv):
    p = common.build_parser(
        "QDDM noise robustness (FashionMNIST)",
        default_models=DEFAULT_MODELS, default_data="fashion_28x28",
        default_img_size=28, default_label=3, default_ds_size=500,
        default_epochs=50, default_batch_size=1, default_tau=10,
        with_noise_intensity=True,
        default_save_path="results/noise/fashion_",
        default_load_path="results/noise/fashion_")
    p.add_argument(
        "--all-noise-types", action="store_true",
        help="sweep noise types 1-3 (phase/amplitude damping + "
             "depolarizing) instead of the reference's default "
             "depolarizing-only loop (src/fashion_noise.py:429)")
    return p.parse_args(argv)


def main(argv=None):
    common.initial_log()
    args = parse_args(sys.argv[1:] if argv is None else argv)
    args.label = 0  # reference main loop trains label 0 (src/*_noise.py:360)
    intensities = [0.1, 0.2, 0.3, 0.5, 0.8]
    noise_types = range(1, 4) if args.all_noise_types else range(3, 4)
    return noise_common.run_noise_sweep(
        args, noise_types=noise_types, intensities=intensities,
        gen_img_count=1, real_img_count=90)


if __name__ == "__main__":
    main()
