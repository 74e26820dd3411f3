"""The FashionMNIST sweep (counterpart of ``qiddm_tpu/cli/fashion_ray.py``,
reference src/fashion_ray.py, a clone of mnist_ray over FashionMNIST):
``mnist_ray`` with ``--data fashion_28x28 --exp-name train_fmnist28``
unless ``--data`` is given.

    python -m qiddm_tpu_torch.cli.fashion_ray --device cuda
"""

from __future__ import annotations

import sys

from . import mnist_ray


def parse_args(argv):
    return mnist_ray.parse_args(argv)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not any(a.startswith("--data") for a in argv):
        argv = ["--data", "fashion_28x28", "--exp-name", "train_fmnist28",
                *argv]
    return mnist_ray.main(argv)


if __name__ == "__main__":
    main()
