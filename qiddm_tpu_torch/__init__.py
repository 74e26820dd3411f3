"""qiddm_tpu_torch — the PyTorch and CUDA port of qiddm_tpu for NVIDIA Hopper.

The port mirrors the JAX package's module paths (``sim``, ``nn``,
``diffusion``, ``ckpt``, ``cli``) and is held against it by the
``tests/test_torch_*.py`` parity tests. Where the JAX package runs a Pallas
kernel, the port runs a CUDA kernel written for ``sm_90a``
(``qiddm_tpu_torch/csrc``); everything else is plain PyTorch. The package
never imports JAX.

What is ported so far is the ``QIDDM_LL_noise`` sampling path
(``python -m qiddm_tpu_torch.cli.sample``) and its training path
(``python -m qiddm_tpu_torch.cli.mnist_exm``); ROADMAP.md lists the rest.
"""

from . import config  # noqa: F401

__version__ = "0.1.0"
