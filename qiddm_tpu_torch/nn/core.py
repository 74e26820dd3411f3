"""The re-uploading denoiser family (counterpart of
``qiddm_tpu/nn/core.py::Reupload``).

N blocks of [L x (per-wire encode -> SEL(k, CZ))] between a linear
down-projection and a linear up-projection (or the probability
post-processing). Modules take NCHW images ``(b, 1, w, h)`` and return the
same shape. Only the options the ported models use exist; the PCA and conv
projections, shared weights, per-block post-processing, BatchNorm and noise
are ROADMAP Queue 1 items 5, 7 and 8.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..sim import engine
from .initializers import qweight_init
from .layers import TorchDense, flatten_img, postprocess_probs, unflatten_img

_OPTIONS = {"down": ("linear",), "up": ("linear", "none"),
            "readout": ("expvalz", "probs"), "encode": ("rz", "rz_halfpi")}


class Reupload(torch.nn.Module):
    """Parameters carry the flax names: ``linear_down``, ``qweights``
    (N, L, k, hidden, 3) and ``linear_up``."""

    def __init__(self, hidden: int, L: int, N: int, *,
                 generator: torch.Generator,
                 input_dim: Optional[int] = None,
                 shape: Tuple[int, int] = (28, 28), k: int = 2,
                 down: str = "linear", up: str = "linear",
                 readout: str = "expvalz", encode: str = "rz"):
        super().__init__()
        for name, value in (("down", down), ("up", up),
                            ("readout", readout), ("encode", encode)):
            if value not in _OPTIONS[name]:
                raise NotImplementedError(
                    f"Reupload {name}={value!r} is not ported (ported: "
                    f"{_OPTIONS[name]}); see ROADMAP Queue 1")
        self.hidden, self.L, self.N, self.k = hidden, L, N, k
        self.shape = tuple(shape)
        self.up, self.readout, self.encode = up, readout, encode
        pixels = self.shape[0] * self.shape[1]
        self.linear_down = TorchDense(pixels, hidden, generator=generator)
        self.qweights = torch.nn.Parameter(
            qweight_init((N, L, k, hidden, 3), generator))
        if up == "linear":
            feat = hidden if readout == "expvalz" else 2**hidden
            self.linear_up = TorchDense(feat, input_dim or pixels,
                                        generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        width, height = self.shape
        cur = self.linear_down(flatten_img(x))
        for n in range(self.N):
            # each block re-encodes the first `hidden` outputs of the last
            cur = engine.reupload_block(
                cur[:, :self.hidden], self.qweights[n], encode=self.encode,
                imprimitive="cz", readout=self.readout)
        if self.up == "none":
            out = postprocess_probs(cur, width * height)
        else:
            out = self.linear_up(cur)
        return unflatten_img(out, width, height)
