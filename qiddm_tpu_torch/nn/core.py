"""The denoiser families (counterpart of ``qiddm_tpu/nn/core.py``):

* ``QDense`` — amplitude embedding -> SEL(depth, CNOT) -> probabilities
  scaled back to pixel space (the Qdense baseline);
* ``QNNA`` — a linear down-projection, the RY product state -> SEL(depth,
  CNOT) -> probabilities scaled back to pixel space (QNN_A);
* ``QNNDense`` — a linear sandwich around one RZ encode -> SEL(depth, CZ)
  -> PauliZ expectations (QNN);
* ``Reupload`` — N blocks of [L x (per-wire RZ or RY encode -> SEL(k,
  CZ))] between a linear, PCA, conv or no down-projection and a linear or
  inverse-PCA up-projection (or the probability post-processing), with
  shared weights, per-block post-processing and BatchNorm as options
  (QIDDM, differN).

Modules take NCHW images ``(b, 1, w, h)`` and return the same shape.
Parameters and buffers carry the flax names, so ``ckpt._flax_paths`` maps
them. A BatchNorm normalises by the batch in training mode and by its
running statistics in eval mode; ``Diffusion`` sets the mode (training
losses train, sampling evaluates), as the JAX package's ``train`` flag
does.

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

from ..pca import (PCAState, pca_fit, pca_fit_transform,
                   pca_inverse_transform, pca_transform)
from ..sim import engine
from .initializers import qweight_init
from .layers import (FlaxBatchNorm, TorchConv, TorchDense, flatten_img,
                     postprocess_probs, unflatten_img)


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


_OPTIONS = {"down": ("linear", "pca", "conv", "none", "pca2_bn_linear"),
            "up": ("linear", "pca_inverse", "linear_then_pca_inverse",
                   "none"),
            "readout": ("expvalz", "probs"),
            "encode": ("rz", "rz_halfpi", "ry"),
            "noise_family": tuple(engine._FAMILY_NOISE)}


class LazyPCA(torch.nn.Module):
    """A PCA fitted once, on the init batch, and frozen (the JAX package's
    ``pca_state`` collection, ``qiddm_tpu/nn/core.py:299-311``): the
    buffers ``mean`` (D,) and ``components`` (n, D), which training leaves
    alone and checkpoints carry."""

    def __init__(self, n_components: int, dim: int):
        super().__init__()
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("components", torch.zeros(n_components, dim))

    @torch.no_grad()
    def fit(self, x_flat: torch.Tensor) -> None:
        st = pca_fit(x_flat.to(self.mean), self.components.shape[0])
        self.mean.copy_(st.mean)
        self.components.copy_(st.components)

    def state(self) -> PCAState:
        return PCAState(mean=self.mean, components=self.components)


class Reupload(torch.nn.Module):
    """N blocks of [L x (per-wire encode -> SEL(k, CZ))] between a down-
    and an up-projection (``qiddm_tpu/nn/core.py:148-311``).

    down: "linear" | "pca" (refitted on every forward batch, or with
    ``pca_lazy`` fitted once by :meth:`fit_lazy_pca`) | "conv" (3x3,
    stride 2, then the spatial mean) | "none" (the first ``hidden`` pixels)
    | "pca2_bn_linear" (lazy PCA(2h) -> BatchNorm -> Linear(h));
    up: "linear" | "pca_inverse" | "linear_then_pca_inverse" (Linear(2h)
    -> inverse PCA) | "none" (the probabilities post-processed to pixels).
    ``shared_weights`` gives every block one ``qweights`` (L, k, hidden,
    3); ``post_each_block`` post-processes a probabilities readout after
    each block; ``batchnorm_pre_block`` applies ONE BatchNorm (``bn``)
    before every block; ``bias`` is ``linear_down``'s only. An unknown
    option raises ``ValueError``.

    Parameters and buffers carry the flax names (``linear_down``,
    ``conv_down``, ``pca_bn``, ``bn``, ``qweights``, ``linear_up``,
    ``pca_state``), so ``ckpt._flax_paths`` maps them."""

    def __init__(self, hidden: int, L: int, N: int, *,
                 generator: torch.Generator,
                 input_dim: Optional[int] = None,
                 shape: Tuple[int, int] = (28, 28), k: int = 2,
                 down: str = "linear", up: str = "linear",
                 readout: str = "expvalz", encode: str = "rz",
                 shared_weights: bool = False, post_each_block: bool = False,
                 batchnorm_pre_block: bool = False, bias: bool = True,
                 pca_lazy: bool = False, add_noise: int = 0,
                 noise_family: str = "qiddm", noise_intensity=None,
                 noise_trajectories: int = 0):
        super().__init__()
        for name, value in (("down", down), ("up", up),
                            ("readout", readout), ("encode", encode),
                            ("noise_family", noise_family)):
            if value not in _OPTIONS[name]:
                raise ValueError(f"unknown {name}={value!r} (known: "
                                 f"{_OPTIONS[name]})")
        self.hidden, self.L, self.N, self.k = hidden, L, N, k
        self.shape = tuple(shape)
        self.down, self.up = down, up
        self.readout, self.encode = readout, encode
        self.shared_weights = shared_weights
        self.post_each_block = post_each_block
        self.batchnorm_pre_block = batchnorm_pre_block
        self.pca_lazy = pca_lazy
        self.add_noise, self.noise_family = add_noise, noise_family
        self.noise_intensity = noise_intensity
        self.noise_trajectories = noise_trajectories
        pixels = self.shape[0] * self.shape[1]
        if down == "linear":
            self.linear_down = TorchDense(pixels, hidden, bias=bias,
                                          generator=generator)
        elif down == "conv":
            self.conv_down = TorchConv(1, hidden, kernel_size=(3, 3),
                                       stride=(2, 2), padding=(1, 1),
                                       generator=generator)
        elif down == "pca" and pca_lazy:
            self.pca_state = LazyPCA(hidden, pixels)
        elif down == "pca2_bn_linear":
            self.pca_state = LazyPCA(2 * hidden, pixels)
            self.pca_bn = FlaxBatchNorm(2 * hidden)
            self.linear_down = TorchDense(2 * hidden, hidden,
                                          generator=generator)
        qshape = (L, k, hidden, 3) if shared_weights else (N, L, k, hidden, 3)
        self.qweights = torch.nn.Parameter(qweight_init(qshape, generator))
        if batchnorm_pre_block:
            self.bn = FlaxBatchNorm(pixels if down == "none" else hidden)
        if up in ("linear", "linear_then_pca_inverse"):
            if readout == "expvalz":
                feat = hidden
            else:
                feat = (min(2**hidden, pixels) if post_each_block
                        else 2**hidden)
            out = (input_dim or pixels) if up == "linear" else 2 * hidden
            self.linear_up = TorchDense(feat, out, generator=generator)

    @property
    def needs_init_batch(self) -> bool:
        return hasattr(self, "pca_state")

    def fit_lazy_pca(self, init_batch: torch.Tensor) -> None:
        """Fit the lazy PCA on ``init_batch`` (b, 1, w, h), as the JAX
        module's init does."""
        self.pca_state.fit(flatten_img(init_batch))

    def _block_weights(self, n: int) -> torch.Tensor:
        return self.qweights if self.shared_weights else self.qweights[n]

    def forward(self, x: torch.Tensor, traj_rng=None) -> torch.Tensor:
        width, height = self.shape
        pixels = width * height
        x_flat = flatten_img(x)
        pca = None
        if self.down == "linear":
            cur = self.linear_down(x_flat)
        elif self.down == "pca":
            if self.pca_lazy:
                pca = self.pca_state.state()
                cur = pca_transform(pca, x_flat)
            else:
                # the reference refits the PCA on every forward batch
                # (nn/qdense.py:456)
                pca, cur = pca_fit_transform(x_flat, self.hidden)
        elif self.down == "conv":
            c = self.conv_down(x)
            cur = c.reshape(x.shape[0], self.hidden, -1).mean(dim=2)
        elif self.down == "none":
            cur = x_flat
        else:  # pca2_bn_linear
            pca = self.pca_state.state()
            cur = self.linear_down(self.pca_bn(pca_transform(pca, x_flat)))
        noise = _resolve_noise(self, self.noise_family)
        traj = _traj_kwargs(self, noise, traj_rng)
        for n in range(self.N):
            if self.batchnorm_pre_block:
                # one BatchNorm for every block: its statistics move once a
                # block, N times a training forward, as flax's do
                cur = self.bn(cur)
            # each block re-encodes the first `hidden` outputs of the last
            # (and draws its own trajectories)
            cur = engine.reupload_block(
                cur[:, :self.hidden], self._block_weights(n),
                encode=self.encode, imprimitive="cz", noise=noise,
                readout=self.readout, **traj)
            if self.readout == "probs" and self.post_each_block:
                cur = postprocess_probs(cur, pixels)
        if self.up == "none":
            out = cur if self.post_each_block else postprocess_probs(cur,
                                                                     pixels)
        elif self.up == "linear":
            out = self.linear_up(cur)
        elif self.up == "pca_inverse":
            out = pca_inverse_transform(pca, cur)
        else:  # linear_then_pca_inverse
            out = pca_inverse_transform(pca, self.linear_up(cur))
        return unflatten_img(out, width, height)
