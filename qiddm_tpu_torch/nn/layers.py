"""Shared building blocks (counterpart of ``qiddm_tpu/nn/layers.py``):
the torch-initialized dense and conv layers, flax's BatchNorm, probability
post-processing and the image flatten/unflatten helpers."""

from __future__ import annotations

import torch

from .initializers import torch_uniform


class TorchDense(torch.nn.Linear):
    """``nn.Linear`` with torch's default ``U(+-1/sqrt(fan_in))`` init drawn
    from an explicit generator. The weight is (out, in); the JAX package's
    flax kernel is its transpose, (in, out)."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator: torch.Generator, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        with torch.no_grad():
            self.weight.copy_(torch_uniform((out_features, in_features),
                                            in_features, generator))
            if bias:
                self.bias.copy_(torch_uniform((out_features,), in_features,
                                              generator))


class TorchConv(torch.nn.Conv2d):
    """``nn.Conv2d`` on NCHW images with torch's default
    ``U(+-1/sqrt(fan_in))`` init (fan_in = in_channels * kh * kw) for
    weight and bias, drawn from an explicit generator. The weight is
    (out, in, kh, kw); the JAX package's flax kernel is (kh, kw, in, out)
    under ``<name>/Conv_0``."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 generator: torch.Generator, kernel_size=(3, 3),
                 stride=(1, 1), padding=(1, 1), bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, bias=bias)
        shape = tuple(self.weight.shape)
        fan_in = shape[1] * shape[2] * shape[3]
        with torch.no_grad():
            self.weight.copy_(torch_uniform(shape, fan_in, generator))
            if bias:
                self.bias.copy_(torch_uniform((out_channels,), fan_in,
                                              generator))


class FlaxBatchNorm(torch.nn.Module):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5, axis=axis)``: one
    scale, bias and pair of running statistics for each index of the
    feature axis ``axis``, reduced over every other axis: dim 0 of
    (batch, features) with the default ``axis=-1``, (N, H, W) of an NCHW
    image batch with ``axis=1`` (the U-Net's).

    In training it normalises by the batch's mean and *biased* variance,
    computed as flax does (E[x^2] - E[x]^2, clipped at 0), and moves the
    running statistics ``ra = 0.9 ra + 0.1 batch`` with that same biased
    variance, once a call; in eval it normalises by the running statistics.
    ``torch.nn.BatchNorm1d`` and ``BatchNorm2d`` are not this: their
    running variance takes the unbiased estimate. ``weight``/``bias`` are
    flax's ``scale``/``bias``, the buffers ``running_mean``/``running_var``
    its ``batch_stats`` ``mean``/``var``."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, axis: int = -1):
        super().__init__()
        self.momentum, self.eps, self.axis = momentum, eps, axis
        self.weight = torch.nn.Parameter(torch.ones(features))
        self.bias = torch.nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = self.axis % x.ndim
        reduced = tuple(d for d in range(x.ndim) if d != axis)
        if self.training:
            mean = x.mean(dim=reduced)
            var = torch.clamp((x * x).mean(dim=reduced) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = [1] * x.ndim
        shape[axis] = -1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.reshape(shape)) * mul.reshape(shape)
                + self.bias.reshape(shape))

    def extra_repr(self) -> str:
        return (f"{self.weight.shape[0]}, momentum={self.momentum}, "
                f"eps={self.eps}, axis={self.axis}")


def flatten_img(x: torch.Tensor) -> torch.Tensor:
    """(b, 1, w, h) -> (b, w*h)."""
    return x.reshape(x.shape[0], -1)


def unflatten_img(x: torch.Tensor, width: int, height: int) -> torch.Tensor:
    return x.reshape(x.shape[0], 1, width, height)


def postprocess_probs(probs: torch.Tensor, pixels: int) -> torch.Tensor:
    """Truncate to the pixel count, rescale, clamp (the reference's
    ``_post_process``)."""
    return torch.clamp(probs[..., :pixels] * pixels, 0.0, 1.0)
