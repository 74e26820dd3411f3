"""Parameter initializers matching the reference's torch defaults
(counterpart of ``qiddm_tpu/nn/initializers.py``).

Quantum weights are ``randn(shape) * 0.4``; Linear kernels and biases are
``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``; a quantum convolution's weights are
``U[0, 1) * pi - pi/2``. Every draw comes from the ``torch.Generator`` the
caller passes.
"""

from __future__ import annotations

import math

import torch


def qweight_init(shape, generator: torch.Generator,
                 stddev: float = 0.4) -> torch.Tensor:
    return stddev * torch.randn(shape, generator=generator,
                                dtype=torch.float32)


def torch_uniform(shape, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * bound


def qconv_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """QConv2d's weights: ``U[0, 1) * pi - pi/2`` (reference
    nn/qconv.py:36-38)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * math.pi - math.pi / 2
