"""The denoiser families (counterpart of ``qiddm_tpu/nn/core.py``):

* ``QDense`` — amplitude embedding -> SEL(depth, CNOT) -> probabilities
  scaled back to pixel space (the Qdense baseline);
* ``QNNDense`` — a linear sandwich around one RZ encode -> SEL(depth, CZ)
  -> PauliZ expectations (QNN);
* ``Reupload`` — N blocks of [L x (per-wire encode -> SEL(k, CZ))] between
  a linear down-projection and a linear up-projection (or the probability
  post-processing) (QIDDM).

Modules take NCHW images ``(b, 1, w, h)`` and return the same shape.
Parameters carry the flax names, so ``ckpt._flax_paths`` maps them. Only
the options the ported models use exist; ``QNNA``, the PCA and conv
projections, shared weights, per-block post-processing, BatchNorm and noise
are ROADMAP Queue 1 items 5, 7 and 8.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..sim import engine
from .initializers import qweight_init
from .layers import TorchDense, flatten_img, postprocess_probs, unflatten_img


class QDense(torch.nn.Module):
    """Amplitude-embedded dense variational circuit (reference
    ``QDenseUndirected_old``, nn/qdense.py:15-68, and its noise variant,
    :71-125): wires = ceil(log2(pixels)), ``qweights`` (qdepth, wires, 3)
    through ``weight_map``, CNOT ring, probabilities post-processed to
    pixels."""

    def __init__(self, qdepth: int, shape: Tuple[int, int], *,
                 generator: torch.Generator, weight_map: str = "qw_tanh"):
        super().__init__()
        self.shape = tuple(shape)
        self.weight_map = weight_map
        self.wires = max(1, math.ceil(math.log2(shape[0] * shape[1])))
        self.qweights = torch.nn.Parameter(
            qweight_init((qdepth, self.wires, 3), generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        width, height = self.shape
        p = engine.qdense_circuit(flatten_img(x), self.qweights,
                                  wires=self.wires, pad_with=0.1,
                                  weight_map=self.weight_map,
                                  imprimitive="cnot")
        return unflatten_img(postprocess_probs(p, width * height), width,
                             height)


class QNNDense(torch.nn.Module):
    """Linear sandwich around a single-encode CZ circuit (reference
    ``QNN`` / ``QNN_noise``, nn/qdense.py:219-386): ``linear_down``
    (input_dim -> hidden), ``qweights`` (qdepth, hidden, 3), ``linear_up``
    (hidden -> input_dim). The circuit RZ-encodes the fresh |0..0> state,
    so its output does not depend on the input (kept, as in the JAX
    package)."""

    def __init__(self, input_dim: int, hidden_features: int, qdepth: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.linear_down = TorchDense(input_dim, hidden_features,
                                      generator=generator)
        self.qweights = torch.nn.Parameter(
            qweight_init((qdepth, hidden_features, 3), generator))
        self.linear_up = TorchDense(hidden_features, input_dim,
                                    generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.linear_down(flatten_img(x))
        q = engine.qnn_circuit(h, self.qweights, encode="rz",
                               imprimitive="cz", readout="expvalz")
        return self.linear_up(q).reshape(x.shape)


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
