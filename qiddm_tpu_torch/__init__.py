"""qiddm_tpu_torch — the PyTorch and CUDA port of qiddm_tpu for NVIDIA Hopper.

The port mirrors the JAX package's module paths (``sim``, ``nn``,
``diffusion``, ``ckpt``, ``cli``) and is held against it by the
``tests/test_torch_*.py`` parity tests. Where the JAX package runs a Pallas
kernel, the port runs a CUDA kernel written for ``sm_90a``
(``qiddm_tpu_torch/csrc``); everything else is plain PyTorch. The package
never imports JAX.

What is ported so far is sampling (``python -m qiddm_tpu_torch.cli.sample``)
and training (``python -m qiddm_tpu_torch.cli.mnist_exm``) of all 28 dense
models of ``qiddm_tpu/nn/qdense.py`` (the re-uploading QIDDM-L and differN
families with every projection option, the QNN family and the Qdense
baseline), the U-Nets with quantum or classical convolutions and the
DeepConv baselines (``nn/unet.py``, ``nn/qconv.py``, ``nn/conv.py``; plain
PyTorch, as the JAX package computes them outside any Pallas kernel), and
the noise drivers, the sweeps and every experiment driver, the AOT
serving artifacts (``export``), and the application layer around them: the
torch-style training call (``Diffusion.attach_optimizer``), the
reference's ``.pt`` state dicts and a ``torch.distributed.checkpoint``
counterpart of the orbax backend (``ckpt``), parameter-shift gradients
(``sim.gradients``), the QASM bridge (``sim.qasm``) with the native C++
engine on the host (``native``), and the plots (``metrics``); ROADMAP.md
lists the rest.
"""

from . import config  # noqa: F401

__version__ = "0.1.0"
