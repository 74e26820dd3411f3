"""Classical deep-CNN baselines (counterpart of ``qiddm_tpu/nn/conv.py``;
reference nn/conv.py)."""

from __future__ import annotations

from typing import Tuple

import torch

from .layers import TorchConv
from .shim import DenoiserShim
from .utils import _labels, get_label_embedding


class DeepConvModule(torch.nn.Module):
    """[Conv3x3 -> ReLU]* with a final Sigmoid (reference nn/conv.py:7-31).

    mode: ``"undirected"`` (plain), ``"multi"`` (the label as a constant
    channel concatenated before every conv, the last ReLU replaced by the
    Sigmoid, nn/conv.py:40-68) or ``"single"`` (the sinusoidal label mask
    added to the input, nn/conv.py:77-83). Convs ``conv0``, ``conv1``, ...
    as the flax module names them."""

    def __init__(self, channels: Tuple[int, ...], mode: str = "undirected",
                 shape: Tuple[int, int] = (28, 28), *,
                 generator: torch.Generator):
        super().__init__()
        if mode not in ("undirected", "multi", "single"):
            raise ValueError(f"unknown mode {mode!r}")
        self.channels, self.mode, self.shape = tuple(channels), mode, shape
        extra = 1 if mode == "multi" else 0
        for i in range(len(channels) - 1):
            self.add_module(f"conv{i}", TorchConv(
                channels[i] + extra, channels[i + 1], kernel_size=(3, 3),
                padding=(1, 1), generator=generator))

    def forward(self, x: torch.Tensor, y=None) -> torch.Tensor:
        if x.ndim != 4:
            raise ValueError("Input must be 4D tensor")
        if self.mode == "single":
            x = x + get_label_embedding(y, *self.shape, device=x.device)
        if self.mode == "multi":
            yc = _labels(y, x.device).to(x.dtype).reshape(-1, 1, 1, 1).expand(
                x.shape[0], 1, x.shape[2], x.shape[3])
        n = len(self.channels) - 1
        for i in range(n):
            if self.mode == "multi":
                x = torch.cat([x, yc], dim=1)
            x = getattr(self, f"conv{i}")(x)
            if self.mode == "multi" and i == n - 1:
                x = torch.sigmoid(x)  # in place of the last ReLU (:58)
            else:
                x = torch.relu(x)
        if self.mode != "multi":
            x = torch.sigmoid(x)  # the appended Sigmoid (:25)
        return x


class ConvShim(DenoiserShim):
    """A conv denoiser's shim: ``forward(x, y=None)``, the labels ``y``
    read by the directed classes only (``self.directed``), as the JAX
    shims' ``__call__(x, y)``. ``Diffusion``'s loss and sampler pass
    images alone, as the JAX package's do, so a directed class raises
    there: it runs under a caller that passes its labels."""

    directed = False

    def forward(self, x: torch.Tensor, y=None) -> torch.Tensor:
        return self.module(x, y)


class _DeepConvShim(ConvShim):
    _mode = _prefix = ""

    def _build(self, channels, shape, seed: int, device) -> None:
        channels = tuple(int(c) for c in channels)
        if channels[0] != channels[-1]:
            raise ValueError("Input and output channels must be equal")
        shape = (shape, shape) if isinstance(shape, int) else tuple(shape)
        self.channels = channels
        module = DeepConvModule(channels, self._mode, shape,
                                generator=torch.Generator().manual_seed(seed))
        super().__init__(module, shape, device=device,
                         save_name_str=self._prefix
                         + "_".join(map(str, channels)))


class DeepConvUndirected(_DeepConvShim):
    """Reference nn/conv.py:7-37."""

    _mode, _prefix = "undirected", "deep_conv_undirected_"

    def __init__(self, channels, shape, seed: int = 0, *, device=None):
        self._build(channels, shape, seed, device)


class DeepConvDirectedMulti(_DeepConvShim):
    """Reference nn/conv.py:40-74."""

    directed = True
    _mode, _prefix = "multi", "deep_conv_directed_multi_"

    def __init__(self, channels, shape=(28, 28), seed: int = 0, *,
                 device=None):
        self._build(channels, shape, seed, device)


class DeepConvDirectedSingle(_DeepConvShim):
    """Reference nn/conv.py:77-89."""

    directed = True
    _mode, _prefix = "single", "deep_conv_directed_single_"

    def __init__(self, channels, shape, seed: int = 0, *, device=None):
        self._build(channels, shape, seed, device)
