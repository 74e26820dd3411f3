"""MNIST experiment driver (counterpart of ``qiddm_tpu/cli/mnist_exm.py``,
reference src/mnist_exm.py).

    python -m qiddm_tpu_torch.cli.mnist_exm --device cuda

Same flags and defaults as the JAX driver; trains label 4 like the
reference main (src/mnist_exm.py:354). Without ``--model`` it trains both
default models in turn, ``QIDDM_LL_noise 784 6 14 2`` and ``QNN_noise 784
8 14``, each at its own default learning rate and into its own checkpoint;
``--model NAME ARGS...`` (repeatable) replaces the list.
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
        "Quantum Denoising Diffusion Model",
        default_models=DEFAULT_MODELS, default_data="mnist_28x28",
        default_img_size=28, default_ds_size=500, default_epochs=50,
        default_batch_size=1, default_tau=10,
        default_save_path="results/formal/fmnist_",
        default_load_path="results/formal/fmnist_")
    return p.parse_args(argv)


def main(argv=None):
    common.initial_log()
    args = parse_args(sys.argv[1:] if argv is None else argv)
    return common.run_labels(args, labels=range(4, 5))


if __name__ == "__main__":
    main()
