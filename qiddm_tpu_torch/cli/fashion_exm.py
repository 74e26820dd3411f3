"""FashionMNIST experiment driver (counterpart of
``qiddm_tpu/cli/fashion_exm.py``, reference src/fashion_exm.py, a clone of
mnist_exm over FashionMNIST).

    python -m qiddm_tpu_torch.cli.fashion_exm --device cuda

Same flags and defaults as the JAX driver: label 4, both default models
(``QIDDM_LL_noise 784 6 14 2`` and ``QNN_noise 784 8 14``), ``tau_test``
twice ``--tau``, and the fashion scoring protocol (generated kept in
[0, 255], one generated image against ten real ones). It reads FashionMNIST
idx files or ``$QIDDM_DATA_DIR/fashion_28.npz``, else synthetic textures.
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
        "Quantum Denoising Diffusion Model (FashionMNIST)",
        default_models=DEFAULT_MODELS, default_data="fashion_28x28",
        default_img_size=28, default_ds_size=500, default_epochs=50,
        default_batch_size=1, default_tau=10,
        default_save_path="results/formal/fashion_",
        default_load_path="results/formal/fashion_")
    return p.parse_args(argv)


def main(argv=None):
    common.initial_log()
    args = parse_args(sys.argv[1:] if argv is None else argv)
    return common.run_labels(args, labels=range(4, 5), tau_test=2 * args.tau,
                             protocol=common.FASHION_PROTOCOL)


if __name__ == "__main__":
    main()
