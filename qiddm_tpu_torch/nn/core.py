"""The denoiser families (counterpart of ``qiddm_tpu/nn/core.py``):

* ``QDense`` — amplitude embedding -> SEL(depth, CNOT) -> probabilities
  scaled back to pixel space (the Qdense baseline);
* ``QNNA`` — a linear down-projection, the RY product state -> SEL(depth,
  CNOT) -> probabilities scaled back to pixel space (QNN_A);
* ``QNNDense`` — a linear sandwich around one RZ encode -> SEL(depth, CZ)
  -> PauliZ expectations (QNN);
* ``Reupload`` — N blocks of [L x (per-wire RZ or RY encode -> SEL(k,
  CZ))] between a linear or PCA down-projection and a linear up-projection
  (or the probability post-processing) (QIDDM).

Modules take NCHW images ``(b, 1, w, h)`` and return the same shape.
Parameters carry the flax names, so ``ckpt._flax_paths`` maps them. Only
the options the ported models use exist; the lazily fitted PCA, the conv
projections, shared weights, per-block post-processing and BatchNorm are
ROADMAP Queue 1 items 5 and 7.

Every family takes ``add_noise`` (the reference's code, 0-4),
``noise_intensity`` and a noise family (the strength table of
``engine._FAMILY_NOISE``). ``noise_intensity`` is a plain attribute: None
(the family's strength), a float, or a 0-d float32 tensor on the module's
device, which the JAX package keeps in its ``noise_cfg`` variables
collection; a sweep sets it per intensity (``cli.common.with_noise``) and
the circuit reads it where it runs, with no host round trip.

``noise_trajectories > 0`` estimates a non-unitary channel with that many
Monte-Carlo trajectories (``sim/trajectories.py``) instead of the density
matrix. ``forward`` then needs ``traj_rng``, a ``torch.Generator`` on the
module's device (the JAX package's "trajectories" rng stream): every
circuit call, each block of a re-uploading model and each QDense or QNN
forward, draws fresh values from it, and a module without one raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..pca import pca_fit_transform
from ..sim import engine
from .initializers import qweight_init
from .layers import TorchDense, flatten_img, postprocess_probs, unflatten_img


def _resolve_noise(mod, family: str):
    """The module's NoiseModel, or None at ``add_noise == 0``
    (``qiddm_tpu/nn/core.py:28-44``)."""
    if mod.add_noise == 0:
        return None
    return engine.noise_from_code(mod.add_noise, family, mod.noise_intensity)


def _traj_kwargs(mod, noise, traj_rng) -> dict:
    """Engine kwargs of the trajectory backend
    (``qiddm_tpu/nn/core.py:47-58``): ``n_traj`` and the random source when
    the module has ``noise_trajectories`` and a non-unitary channel; the
    engine raises if the source is missing."""
    if mod.noise_trajectories and noise is not None and not noise.is_unitary:
        return {"n_traj": mod.noise_trajectories, "traj_rng": traj_rng}
    return {}


class QDense(torch.nn.Module):
    """Amplitude-embedded dense variational circuit (reference
    ``QDenseUndirected_old``, nn/qdense.py:15-68, and its noise variant,
    :71-125): wires = ceil(log2(pixels)), ``qweights`` (qdepth, wires, 3)
    through ``weight_map``, CNOT ring, probabilities post-processed to
    pixels."""

    def __init__(self, qdepth: int, shape: Tuple[int, int], *,
                 generator: torch.Generator, weight_map: str = "qw_tanh",
                 add_noise: int = 0, noise_intensity=None,
                 noise_trajectories: int = 0):
        super().__init__()
        self.shape = tuple(shape)
        self.weight_map = weight_map
        self.add_noise, self.noise_intensity = add_noise, noise_intensity
        self.noise_trajectories = noise_trajectories
        self.wires = max(1, math.ceil(math.log2(shape[0] * shape[1])))
        self.qweights = torch.nn.Parameter(
            qweight_init((qdepth, self.wires, 3), generator))

    def forward(self, x: torch.Tensor, traj_rng=None) -> torch.Tensor:
        width, height = self.shape
        noise = _resolve_noise(self, "qdense")
        p = engine.qdense_circuit(flatten_img(x), self.qweights,
                                  wires=self.wires, pad_with=0.1,
                                  weight_map=self.weight_map,
                                  imprimitive="cnot", noise=noise,
                                  **_traj_kwargs(self, noise, traj_rng))
        return unflatten_img(postprocess_probs(p, width * height), width,
                             height)


class QNNA(torch.nn.Module):
    """Angle(Y)-embedded circuit (reference ``QNN_A``, nn/qdense.py:128-210):
    ``linear_down`` (pixels -> wires), wires = ceil(log2(pixels)), the RY
    product state, ``qweights`` (qdepth, wires, 3) unmapped, CNOT ring,
    probabilities post-processed to pixels."""

    def __init__(self, qdepth: int, shape: Tuple[int, int], *,
                 generator: torch.Generator, add_noise: int = 0,
                 noise_intensity=None, noise_trajectories: int = 0):
        super().__init__()
        self.shape = tuple(shape)
        self.add_noise, self.noise_intensity = add_noise, noise_intensity
        self.noise_trajectories = noise_trajectories
        pixels = shape[0] * shape[1]
        self.wires = max(1, math.ceil(math.log2(pixels)))
        self.linear_down = TorchDense(pixels, self.wires, generator=generator)
        self.qweights = torch.nn.Parameter(
            qweight_init((qdepth, self.wires, 3), generator))

    def forward(self, x: torch.Tensor, traj_rng=None) -> torch.Tensor:
        width, height = self.shape
        h = self.linear_down(flatten_img(x))
        noise = _resolve_noise(self, "qnn_a")
        p = engine.qnn_circuit(h, self.qweights, encode="ry",
                               imprimitive="cnot", readout="probs",
                               noise=noise,
                               **_traj_kwargs(self, noise, traj_rng))
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
                 generator: torch.Generator, add_noise: int = 0,
                 noise_intensity=None, noise_trajectories: int = 0):
        super().__init__()
        self.add_noise, self.noise_intensity = add_noise, noise_intensity
        self.noise_trajectories = noise_trajectories
        self.linear_down = TorchDense(input_dim, hidden_features,
                                      generator=generator)
        self.qweights = torch.nn.Parameter(
            qweight_init((qdepth, hidden_features, 3), generator))
        self.linear_up = TorchDense(hidden_features, input_dim,
                                    generator=generator)

    def forward(self, x: torch.Tensor, traj_rng=None) -> torch.Tensor:
        h = self.linear_down(flatten_img(x))
        noise = _resolve_noise(self, "qnn")
        q = engine.qnn_circuit(h, self.qweights, encode="rz",
                               imprimitive="cz", readout="expvalz",
                               noise=noise,
                               **_traj_kwargs(self, noise, traj_rng))
        return self.linear_up(q).reshape(x.shape)


_OPTIONS = {"down": ("linear", "pca"), "up": ("linear", "none"),
            "readout": ("expvalz", "probs"),
            "encode": ("rz", "rz_halfpi", "ry"), "pca_lazy": (False,),
            "noise_family": tuple(engine._FAMILY_NOISE)}


class Reupload(torch.nn.Module):
    """Parameters carry the flax names: ``linear_down`` (down="linear"
    only: the PCA is refitted on every forward batch and has none),
    ``qweights`` (N, L, k, hidden, 3) and ``linear_up``."""

    def __init__(self, hidden: int, L: int, N: int, *,
                 generator: torch.Generator,
                 input_dim: Optional[int] = None,
                 shape: Tuple[int, int] = (28, 28), k: int = 2,
                 down: str = "linear", up: str = "linear",
                 readout: str = "expvalz", encode: str = "rz",
                 pca_lazy: bool = False, add_noise: int = 0,
                 noise_family: str = "qiddm", noise_intensity=None,
                 noise_trajectories: int = 0):
        super().__init__()
        for name, value in (("down", down), ("up", up),
                            ("readout", readout), ("encode", encode),
                            ("pca_lazy", pca_lazy),
                            ("noise_family", noise_family)):
            if value not in _OPTIONS[name]:
                raise NotImplementedError(
                    f"Reupload {name}={value!r} is not ported (ported: "
                    f"{_OPTIONS[name]}); ROADMAP Queue 1 item 7")
        self.hidden, self.L, self.N, self.k = hidden, L, N, k
        self.shape = tuple(shape)
        self.down, self.up = down, up
        self.readout, self.encode = readout, encode
        self.add_noise, self.noise_family = add_noise, noise_family
        self.noise_intensity = noise_intensity
        self.noise_trajectories = noise_trajectories
        pixels = self.shape[0] * self.shape[1]
        if down == "linear":
            self.linear_down = TorchDense(pixels, hidden, generator=generator)
        self.qweights = torch.nn.Parameter(
            qweight_init((N, L, k, hidden, 3), generator))
        if up == "linear":
            feat = hidden if readout == "expvalz" else 2**hidden
            self.linear_up = TorchDense(feat, input_dim or pixels,
                                        generator=generator)

    def forward(self, x: torch.Tensor, traj_rng=None) -> torch.Tensor:
        width, height = self.shape
        if self.down == "linear":
            cur = self.linear_down(flatten_img(x))
        else:
            # the reference refits the PCA on every forward batch
            # (nn/qdense.py:456)
            _, cur = pca_fit_transform(flatten_img(x), self.hidden)
        noise = _resolve_noise(self, self.noise_family)
        traj = _traj_kwargs(self, noise, traj_rng)
        for n in range(self.N):
            # each block re-encodes the first `hidden` outputs of the last
            # (and draws its own trajectories)
            cur = engine.reupload_block(
                cur[:, :self.hidden], self.qweights[n], encode=self.encode,
                imprimitive="cz", noise=noise, readout=self.readout, **traj)
        if self.up == "none":
            out = postprocess_probs(cur, width * height)
        else:
            out = self.linear_up(cur)
        return unflatten_img(out, width, height)
