"""Shared building blocks (counterpart of ``qiddm_tpu/nn/layers.py``):
the torch-initialized dense layer, probability post-processing and the
image flatten/unflatten helpers."""

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


def flatten_img(x: torch.Tensor) -> torch.Tensor:
    """(b, 1, w, h) -> (b, w*h)."""
    return x.reshape(x.shape[0], -1)


def unflatten_img(x: torch.Tensor, width: int, height: int) -> torch.Tensor:
    return x.reshape(x.shape[0], 1, width, height)


def postprocess_probs(probs: torch.Tensor, pixels: int) -> torch.Tensor:
    """Truncate to the pixel count, rescale, clamp (the reference's
    ``_post_process``)."""
    return torch.clamp(probs[..., :pixels] * pixels, 0.0, 1.0)
