"""The reference's model surface on an ``nn.Module`` (counterpart of
``qiddm_tpu/nn/shim.py``): construct with the reference's ctor arguments
and a seed, call on images, ``save_name()``, ``num_params()``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import resolve_device


def _square_or_flat(input_dim: int) -> Tuple[int, int]:
    side = int(math.isqrt(input_dim))
    if side * side == input_dim:
        return (side, side)
    return (input_dim, 1)


class DenoiserShim(torch.nn.Module):
    """Holds the denoiser as ``self.module``, moved to ``device``: the card
    (``"cuda"``) unless the caller names another device. The device goes
    through ``config.resolve_device``, which raises when CUDA is asked for
    and absent; nothing falls back to the CPU.

    Subclasses build the module on the CPU from a ``torch.Generator``
    seeded with their ``seed``, so one seed gives the same weights on every
    device. The shim starts in eval mode, as the JAX shim's call defaults
    to ``train=False``: a BatchNorm model normalises by its running
    statistics until ``train()`` (``Diffusion``'s training loss sets it).
    """

    def __init__(self, module: torch.nn.Module, img_shape: Tuple[int, int],
                 *, save_name_str: str, device=None):
        super().__init__()
        self.module = module.to(
            resolve_device("cuda" if device is None else device))
        self.img_shape = tuple(img_shape)
        self._save_name = save_name_str
        self.eval()

    def forward(self, x: torch.Tensor, traj_rng=None) -> torch.Tensor:
        """The denoiser on ``x``; ``traj_rng`` is the trajectory noise
        backend's random source (``nn/core.py``)."""
        return self.module(x, traj_rng=traj_rng)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def num_params(self) -> int:
        """The trainable parameters' count, as the JAX shim's (its
        ``params`` collection); buffers (BatchNorm statistics, a lazy PCA)
        are not counted."""
        return sum(p.numel() for p in self.parameters())

    def save_name(self) -> str:
        return self._save_name

    def extra_repr(self) -> str:
        return self._save_name
