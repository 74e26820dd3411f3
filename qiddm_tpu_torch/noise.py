"""Forward-noising schedules (counterpart of ``qiddm_tpu/noise.py``).

The four schedules keep the reference's math and return layout:
``(batch * tau, pixels)``, batch-major (reference src/noise.py). Each takes
a ``torch.Generator`` where the JAX package takes a PRNG key, in the same
position. The noise is drawn on the CPU from that generator and then moved
to the data's device, so one seed gives the same noise on the card and on
the CPU. A schedule's ``noise=`` argument skips the draw and blends the
given noise instead (tests feed the JAX package's draw through it).
"""

from __future__ import annotations

from typing import Optional

import torch


def l1_norm(data: torch.Tensor) -> torch.Tensor:
    """Row-wise L1 normalization (reference src/noise.py:9)."""
    n = data.abs().sum(dim=-1, keepdim=True)
    return data / torch.clamp(n, min=1e-12)


def l2_norm(data: torch.Tensor) -> torch.Tensor:
    """Row-wise L2 normalization (reference src/noise.py:13)."""
    n = torch.sqrt((data * data).sum(dim=-1, keepdim=True))
    return data / torch.clamp(n, min=1e-12)


def _to_batch_major(x: torch.Tensor) -> torch.Tensor:
    """(tau, batch, pixels) -> ((batch tau), pixels)."""
    tau, batch, pixels = x.shape
    return x.transpose(0, 1).reshape(batch * tau, pixels)


def normalize_mean(target_data: torch.Tensor,
                   inp: torch.Tensor) -> torch.Tensor:
    """Rescale noisy rows to the per-image mean of the clean data
    (reference src/noise.py:17-37). ``inp`` may be (tau, batch, pixels) or
    ((batch tau), pixels)."""
    if target_data.ndim == 1:
        target_data = target_data[None, :]
    btp = inp.ndim == 2
    if btp:
        batch = target_data.shape[0]
        inp = inp.reshape(batch, -1, inp.shape[-1]).transpose(0, 1)
    inp_mean = inp.mean(dim=-1, keepdim=True)  # (tau, batch, 1)
    orig_mean = target_data.mean(dim=-1, keepdim=True)[None]  # (1, b, 1)
    # an all-zero row would give 0/0; the sibling norms clamp the same way
    moved = inp / torch.clamp(inp_mean, min=1e-12) * orig_mean
    return _to_batch_major(moved) if btp else moved


def _weighting(tau: int, decay_mod: float, dtype) -> torch.Tensor:
    w = torch.linspace(0.0, 1.0, tau, dtype=dtype) ** decay_mod
    return w / torch.clamp(w.max(), min=1e-12)


def _draw(generator: Optional[torch.Generator], shape, data: torch.Tensor,
          kind: str) -> torch.Tensor:
    """Standard normal or U[0, 1) draws from ``generator`` on the CPU, moved
    to ``data``'s device."""
    fn = torch.randn if kind == "normal" else torch.rand
    return fn(shape, generator=generator, dtype=data.dtype).to(data.device)


def _blend(data: torch.Tensor, noise: torch.Tensor, w: torch.Tensor):
    """``data * (1 - w) + noise * w`` for every weight of the (tau,) curve:
    (tau, batch, pixels)."""
    w = w.to(data.device)[:, None, None]
    return data[None] * (1.0 - w) + noise[None] * w


def add_normal_noise_multiple(generator, data: torch.Tensor, tau: int,
                              decay_mod: float = 1.0,
                              noise: Optional[torch.Tensor] = None):
    """Blend each image with ONE Normal(0.5, 0.2) noise image at tau
    weights, then clip to [0, 1] (reference src/noise.py:105-126 — the
    schedule the experiment drivers use). ``noise``: the (batch, pixels)
    noise image, drawn from ``generator`` when None."""
    if data.ndim == 1:
        data = data[None, :]
    if noise is None:
        noise = 0.5 + 0.2 * _draw(generator, data.shape, data, "normal")
    noisy = _blend(data, noise, _weighting(tau, decay_mod, data.dtype))
    return _to_batch_major(torch.clamp(noisy, 0.0, 1.0))


def add_uniform_noise_multiple(generator, data: torch.Tensor, tau: int,
                               decay_mod: float = 2.0,
                               noise: Optional[torch.Tensor] = None):
    """Same blend with a single U[0,1) noise image, no clip
    (reference src/noise.py:64-82)."""
    if data.ndim == 1:
        data = data[None, :]
    if noise is None:
        noise = _draw(generator, data.shape, data, "uniform")
    return _to_batch_major(
        _blend(data, noise, _weighting(tau, decay_mod, data.dtype)))


def add_uniform_noise_iteratively(generator, data: torch.Tensor, tau: int,
                                  decay_mod: float = 1.0,
                                  noise: Optional[torch.Tensor] = None):
    """Iterative blend with FRESH uniform noise per step; weights are the
    L2-normalized power curve (reference src/noise.py:40-61). ``noise``:
    (tau - 1, batch, pixels), one image per step."""
    if data.ndim == 1:
        data = data[None, :]
    w = torch.linspace(0.0, 1.0, tau, dtype=data.dtype) ** decay_mod
    w = (w / torch.clamp(torch.sqrt((w * w).sum()), min=1e-12)).tolist()
    if noise is None:
        noise = _draw(generator, (tau - 1, *data.shape), data, "uniform")
    steps = [data]
    for t in range(1, tau):
        steps.append(steps[-1] * (1.0 - w[t]) + noise[t - 1] * w[t])
    return _to_batch_major(torch.stack(steps))


def add_noise_normal_iteratively(generator, data: torch.Tensor, tau: int,
                                 decay_mod: float = 0.4,
                                 noise: Optional[torch.Tensor] = None):
    """Iterative Gaussian perturbation with linearly growing std, clamped
    to [0, 1] each step (reference src/noise.py:85-102). ``noise``:
    (tau - 1, batch, pixels) standard normals, one image per step."""
    if data.ndim == 1:
        data = data[None, :]
    stds = torch.linspace(0.0, decay_mod, tau, dtype=data.dtype).tolist()
    if noise is None:
        noise = _draw(generator, (tau - 1, *data.shape), data, "normal")
    steps = [data]
    for t in range(1, tau):
        steps.append(torch.clamp(steps[-1] + stds[t] * noise[t - 1],
                                 0.0, 1.0))
    return _to_batch_major(torch.stack(steps))


SCHEDULES = {
    "add_normal_noise_multiple": add_normal_noise_multiple,
    "add_uniform_noise_multiple": add_uniform_noise_multiple,
    "add_uniform_noise_iteratively": add_uniform_noise_iteratively,
    "add_noise_normal_iteratively": add_noise_normal_iteratively,
}
