"""Diffusion sampling (counterpart of the sampling half of
``qiddm_tpu/diffusion.py``).

Sampling iterates the denoiser from a starting image: the "data" goal
replaces x with the prediction, the "noise" goal subtracts the scaled
prediction and clips (reference src/models.py:106-147). The JAX package
runs the loop as one ``lax.scan``; here it is a Python loop under
``torch.no_grad()``. Training is ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


class Diffusion:
    """Torch-like wrapper pairing a denoiser shim with a prediction goal.

    ``shape`` is (height, width) as the drivers pass it; images flatten in
    the reference's ``(w h)`` order.
    """

    def __init__(self, net, prediction_goal: str = "data",
                 shape: Tuple[int, int] = (28, 28), loss: str = "mse"):
        if prediction_goal not in ("data", "noise"):
            raise ValueError(f"unknown prediction_goal {prediction_goal!r}")
        self.net = net
        self.prediction_goal = prediction_goal
        self.width, self.height = shape
        self.loss = loss
        self.training = False

    # --- torch-like mode switches ------------------------------------------
    def train(self, mode: bool = True):
        self.training = mode
        return self

    def eval(self):
        return self.train(False)

    def save_name(self) -> str:
        suffix = "_noise" if self.prediction_goal == "noise" else ""
        return f"{self.net.save_name()}{suffix}"

    # --- sampling -----------------------------------------------------------
    @torch.no_grad()
    def _denoise_scan(self, first_x: torch.Tensor, n_iters: int,
                      noise_factor: float):
        """The denoise loop shared by every sampling entry point; returns
        (last image batch, list of every iteration's batch)."""
        x = first_x
        xs = []
        for _ in range(n_iters):
            pred = self.net(x)
            if self.prediction_goal == "data":
                x = pred
            else:
                x = torch.clamp(x - (pred - 0.5) * 0.1 * noise_factor,
                                0.0, 1.0)
            xs.append(x)
        return x, xs

    def sample_fn(self, first_x: torch.Tensor, n_iters: int, *,
                  only_last: bool = False, step: int = 1,
                  noise_factor: float = 1.0) -> torch.Tensor:
        """first_x: (b, 1, w, h). Returns the last batch (``only_last``) or
        the reference's grid ``(iters*h, b*w)`` of the start and every
        ``step``-th iteration."""
        last, xs = self._denoise_scan(first_x, n_iters, noise_factor)
        if only_last:
            return last
        outp = torch.stack([first_x] + xs[::step])  # (I, b, 1, H, W)
        i, b, _, h, w = outp.shape
        return outp[:, :, 0].permute(0, 2, 1, 3).reshape(i * h, b * w)

    def sample_stack_fn(self, first_x: torch.Tensor, n_iters: int, *,
                        noise_factor: float = 1.0) -> torch.Tensor:
        """The raw (iters+1, b, 1, h, w) stack of the start and every
        iteration."""
        _, xs = self._denoise_scan(first_x, n_iters, noise_factor)
        return torch.stack([first_x] + xs)

    def sample(self, n_iters: int, first_x: Optional[torch.Tensor] = None,
               only_last: bool = False, step: int = 1,
               noise_factor: float = 1.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sample from ``first_x``, or from 10 uniform images drawn on the
        CPU from ``generator`` (seed 0 if none) and moved to the net's
        device."""
        if first_x is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            first_x = torch.rand((10, 1, self.width, self.height),
                                 generator=generator).to(self.net.device)
        return self.sample_fn(first_x, n_iters, only_last=only_last,
                              step=step, noise_factor=noise_factor)
