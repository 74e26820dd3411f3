"""U-Net denoisers with quantum or classical convolutions (counterpart of
``qiddm_tpu/nn/unet.py``).

Reference: nn/unet.py. ``conv2d`` dispatches on qdepth (> 0: ``QConv2d``,
0: a classical conv, :9-24); ``DownBlock`` is [Conv -> BN -> ReLU] x 2 and
a 2x2 max-pool (:78-116); ``UpBlock`` a bilinear x2 upsample and a 1x1
conv, the skip zero-padded to size and concatenated after it, then
[Conv -> ReLU -> BN -> Conv -> BN -> ReLU] (:28-75); ``UNetModule`` doubles
the channels down the levels, halves them up, and ends in a 1x1 conv
(:119-180); the directed class adds the sinusoidal label mask first
(:183-190). The simple blocks are nn/unet_simple.py's: one QConv and a BN.

BatchNorms are flax's over the channel axis of NCHW (``FlaxBatchNorm(...,
axis=1)``), and modules carry the flax names (``down0.conv0``,
``down0.bn1``, ``up1.up_conv``, ``final_conv``, ...), so
``ckpt._flax_paths`` maps every weight and statistic by its path. The
bilinear x2 upsample is ``F.interpolate(..., mode="bilinear",
align_corners=False)``: at a factor of 2 it is ``jax.image.resize``'s
half-pixel interpolation, whose edge taps JAX renormalises where torch
clamps the source index, to the same values (tests/test_torch_qconv.py
holds it at sides 2, 7 and 14).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv import ConvShim
from .layers import FlaxBatchNorm, TorchConv
from .qconv import QConv2d
from .utils import autopad, get_label_embedding


def conv2d(in_channels: int, out_channels: int, kernel_size: int,
           padding: int, qdepth: int, generator: torch.Generator):
    """The quantum or classical conv (reference nn/unet.py:9-24)."""
    ks, pd = (kernel_size, kernel_size), (padding, padding)
    if qdepth > 0:
        return QConv2d(in_channels, out_channels, kernel_size=ks, padding=pd,
                       qdepth=qdepth, generator=generator)
    return TorchConv(in_channels, out_channels, kernel_size=ks, padding=pd,
                     generator=generator)


def _bn(channels: int) -> FlaxBatchNorm:
    return FlaxBatchNorm(channels, momentum=0.9, eps=1e-5, axis=1)


def _pool(x: torch.Tensor) -> torch.Tensor:
    # flax's max_pool with VALID padding floors an odd side, as this does
    return F.max_pool2d(x, kernel_size=2, stride=2)


def _upsample(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, size=(2 * x.shape[2], 2 * x.shape[3]),
                         mode="bilinear", align_corners=False)


class DownBlock(torch.nn.Module):
    """[Conv -> BN -> ReLU] x 2 and an optional 2x2 max-pool; returns
    (pooled, skip)."""

    def __init__(self, in_channels: int, out_channels: int, pooling: bool, *,
                 generator: torch.Generator, kernel_size: int = 3,
                 qdepth: int = 3):
        super().__init__()
        self.pooling = pooling
        self.conv0 = conv2d(in_channels, out_channels, kernel_size, 1,
                            qdepth, generator)
        self.bn0 = _bn(out_channels)
        self.conv1 = conv2d(out_channels, out_channels, kernel_size, 1,
                            qdepth, generator)
        self.bn1 = _bn(out_channels)

    def forward(self, x: torch.Tensor):
        x = torch.relu(self.bn0(self.conv0(x)))
        x = torch.relu(self.bn1(self.conv1(x)))
        return (_pool(x) if self.pooling else x), x


class UpBlock(torch.nn.Module):
    """Bilinear x2 upsample and a 1x1 conv, the skip autopadded and
    concatenated after it, then Conv -> ReLU -> BN -> Conv -> BN -> ReLU
    (reference nn/unet.py:49-68)."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 generator: torch.Generator, kernel_size: int = 3,
                 qdepth: int = 3):
        super().__init__()
        self.up_conv = conv2d(in_channels, out_channels, 1, 0, qdepth,
                              generator)
        self.conv0 = conv2d(2 * out_channels, out_channels, kernel_size, 1,
                            qdepth, generator)
        self.bn0 = _bn(out_channels)
        self.conv1 = conv2d(out_channels, out_channels, kernel_size, 1,
                            qdepth, generator)
        self.bn1 = _bn(out_channels)

    def forward(self, from_down: torch.Tensor,
                from_up: torch.Tensor) -> torch.Tensor:
        up = self.up_conv(_upsample(from_up))
        from_down, up = autopad(from_down, up)
        x = torch.cat([up, from_down], dim=1)
        x = self.bn0(torch.relu(self.conv0(x)))
        return torch.relu(self.bn1(self.conv1(x)))


class SimpleDownBlock(torch.nn.Module):
    """One QConv and a BN, then an optional 2x2 max-pool (reference
    nn/unet_simple.py:6-18); returns (pooled, skip)."""

    def __init__(self, in_channels: int, out_channels: int, pooling: bool, *,
                 generator: torch.Generator, kernel_size: int = 3,
                 qdepth: int = 3):
        super().__init__()
        self.pooling = pooling
        self.qconv = QConv2d(in_channels, out_channels,
                             kernel_size=(kernel_size, kernel_size),
                             padding=(1, 1), qdepth=qdepth,
                             generator=generator)
        self.bn = _bn(out_channels)

    def forward(self, x: torch.Tensor):
        x = self.bn(self.qconv(x))
        return (_pool(x) if self.pooling else x), x


class SimpleUpBlock(torch.nn.Module):
    """Bilinear x2 upsample and a 1x1 QConv, the skip autopadded and
    concatenated after it, then one QConv and a BN (reference
    nn/unet_simple.py:21-49)."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 generator: torch.Generator, kernel_size: int = 3,
                 qdepth: int = 3):
        super().__init__()
        self.up_qconv = QConv2d(in_channels, out_channels, kernel_size=(1, 1),
                                padding=(0, 0), qdepth=qdepth,
                                generator=generator)
        self.qconv = QConv2d(2 * out_channels, out_channels,
                             kernel_size=(kernel_size, kernel_size),
                             padding=(1, 1), qdepth=qdepth,
                             generator=generator)
        self.bn = _bn(out_channels)

    def forward(self, from_down: torch.Tensor,
                from_up: torch.Tensor) -> torch.Tensor:
        up = self.up_qconv(_upsample(from_up))
        from_down, up = autopad(from_down, up)
        return self.bn(self.qconv(torch.cat([up, from_down], dim=1)))


class UNetModule(torch.nn.Module):
    """The U-Net on NCHW images of one channel (reference
    nn/unet.py:119-180): ``depth`` levels of ``start_channels * 2**i``
    channels, pooled between levels; ``depth - 1`` up blocks back; a 1x1
    conv to one channel. ``directed`` adds the sinusoidal label mask of the
    labels ``y`` to the input; ``simple`` takes the single-QConv blocks."""

    def __init__(self, depth: int = 3, start_channels: int = 8,
                 qdepth: int = 3, directed: bool = False,
                 simple: bool = False, *, generator: torch.Generator):
        super().__init__()
        if depth <= 0:
            raise ValueError("Depth must be greater than 0")
        self.depth, self.directed = depth, directed
        down = SimpleDownBlock if simple else DownBlock
        up = SimpleUpBlock if simple else UpBlock
        out_channel = -1
        for i in range(depth):
            in_channel = 1 if i == 0 else out_channel
            out_channel = start_channels * 2**i
            self.add_module(f"down{i}", down(
                in_channel, out_channel, i < depth - 1, qdepth=qdepth,
                generator=generator))
        for i in range(depth - 1):
            in_channel, out_channel = out_channel, out_channel // 2
            self.add_module(f"up{i}", up(in_channel, out_channel,
                                         qdepth=qdepth, generator=generator))
        self.final_conv = conv2d(out_channel, 1, 1, 0, qdepth, generator)

    def forward(self, x: torch.Tensor, y=None) -> torch.Tensor:
        if self.directed:
            x = x + get_label_embedding(y, x.shape[2], x.shape[3],
                                        device=x.device)
        skips = []
        for i in range(self.depth):
            x, before = getattr(self, f"down{i}")(x)
            skips.append(before)
        for i in range(self.depth - 1):
            x = getattr(self, f"up{i}")(skips[-(i + 2)], x)
        return self.final_conv(x)


# ---------------------------------------------------------------------------
# public shims
# ---------------------------------------------------------------------------

class _UNetShim(ConvShim):
    _simple = False
    _name_prefix = ""

    def __init__(self, depth=3, start_channels=8, qdepth=3, seed: int = 0,
                 img_shape=(28, 28), *, device=None):
        depth, start_channels, qdepth = (int(depth), int(start_channels),
                                         int(qdepth))
        self.depth, self.start_channels, self.qdepth = (depth, start_channels,
                                                        qdepth)
        module = UNetModule(depth, start_channels, qdepth,
                            directed=self.directed, simple=self._simple,
                            generator=torch.Generator().manual_seed(seed))
        super().__init__(
            module, img_shape, device=device,
            save_name_str=(f"{self._name_prefix}_d{depth}_s{start_channels}"
                           f"_d{qdepth}"))


class UNetUndirected(_UNetShim):
    """Reference nn/unet.py:119-180."""

    _name_prefix = "unet_undirected"


class UnetDirected(_UNetShim):
    """Reference nn/unet.py:183-190."""

    directed = True
    _name_prefix = "unet_directed"


class UNetUndirectedS(_UNetShim):
    """Reference nn/unet_simple.py:52-84."""

    _simple = True
    _name_prefix = "unet_s_undirected"


class UnetDirectedS(UnetDirected):
    """Reference nn/unet_simple.py:87-94."""

    _simple = True
    _name_prefix = "unet_s_directed"
