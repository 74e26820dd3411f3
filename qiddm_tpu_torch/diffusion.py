"""Diffusion training and sampling (counterpart of
``qiddm_tpu/diffusion.py``).

* Training ("data" goal): noise each image into a tau+1 chain, train the
  denoiser to map chain step t+1 -> t, MSE (reference src/models.py:44-72).
* Training ("noise" goal): predict the added noise through the affine map
  ``(net(x) - 0.5) * 0.1`` (reference src/models.py:74-104).
* Sampling iterates the denoiser from a starting image: the "data" goal
  replaces x with the prediction, the "noise" goal subtracts the scaled
  prediction and clips (reference src/models.py:106-147).

The JAX package runs a step as a jitted ``value_and_grad`` and all epochs as
one ``lax.scan``; here a step is ``loss.backward()`` and an optimizer step,
and the loops are Python loops. Every random draw (batch order, noise) comes
from a ``torch.Generator`` on the CPU, so a seed gives the same run on the
card and on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .noise import add_normal_noise_multiple


class Diffusion:
    """Torch-like wrapper pairing a denoiser shim with a noise schedule.

    The reference ctor's order (src/models.py:14-27):
    ``Diffusion(net, noise_f, prediction_goal, shape, loss)``. ``noise_f``
    takes ``(generator, data, tau, decay_mod)``. ``shape`` is
    (height, width) as the drivers pass it; images flatten in the
    reference's ``(w h)`` order.
    """

    def __init__(self, net, noise_f=add_normal_noise_multiple,
                 prediction_goal: str = "data",
                 shape: Tuple[int, int] = (28, 28), loss: str = "mse"):
        if prediction_goal not in ("data", "noise"):
            raise ValueError(f"unknown prediction_goal {prediction_goal!r}")
        self.net = net
        self.add_noise = noise_f
        self.prediction_goal = prediction_goal
        self.width, self.height = shape
        self.loss = loss
        self.training = False

    # --- torch-like mode switches ------------------------------------------
    def train(self, mode: bool = True):
        self.training = mode
        self.net.train(mode)
        return self

    def eval(self):
        return self.train(False)

    def save_name(self) -> str:
        suffix = "_noise" if self.prediction_goal == "noise" else ""
        return f"{self.net.save_name()}{suffix}"

    def parameters(self):
        return list(self.net.parameters())

    # --- training -----------------------------------------------------------
    def _chain_loss(self, x_flat: torch.Tensor, T: int, *,
                    generator: Optional[torch.Generator],
                    valid: Optional[torch.Tensor] = None):
        """The tau-chain training loss shared by every train path.

        Builds the noisy chain, pairs step t+1 -> t, runs the denoiser on
        the expanded batch and takes the MSE for the active goal (reference
        src/models.py:44-104). With ``valid`` (a per-row 0/1 vector), padded
        rows get zero weight and the mean normalizes by the real count.
        Returns (loss, (per_elem, recon)).
        """
        tau = T + 1
        chain = self.add_noise(generator, x_flat, tau, 3.0)  # (B*tau, P)
        c = chain.reshape(-1, tau, chain.shape[-1])
        img = (-1, 1, self.width, self.height)  # "(w h)" pixel order
        noisy = c[:, 1:, :].reshape(img)
        clean = c[:, :-1, :].reshape(img)
        recon = self.net(noisy)
        if self.prediction_goal == "data":
            per_elem = (recon - clean) ** 2
        else:
            per_elem = ((recon - 0.5) * 0.1 - (noisy - clean)) ** 2
        if valid is None:
            loss = per_elem.mean()
        else:
            wgt = valid.repeat_interleave(tau - 1)[:, None, None, None]
            denom = (torch.clamp(valid.sum(), min=1.0) * (tau - 1)
                     * per_elem[0].numel())
            loss = (per_elem * wgt).sum() / denom
        return loss, (per_elem, recon)

    def loss_fn(self, x_flat: torch.Tensor, T: int, *,
                generator: Optional[torch.Generator] = None):
        """One training-step loss on a flat image batch ``(B, pixels)``.
        Returns (loss, (per_elem_loss, recon))."""
        return self._chain_loss(x_flat, T, generator=generator)

    def _update(self, optimizer, loss: torch.Tensor) -> None:
        optimizer.zero_grad(set_to_none=False)
        loss.backward()
        optimizer.step()

    def make_train_step(self, optimizer, T: int):
        """``step(x_flat, generator) -> loss``: one loss, backward and
        ``optimizer`` update of the net's parameters. The gradients stay in
        ``.grad`` until the next step."""

        def step(x_flat: torch.Tensor, generator=None) -> torch.Tensor:
            self.train()
            loss, _ = self.loss_fn(x_flat, T, generator=generator)
            self._update(optimizer, loss)
            return loss.detach()

        return step

    def make_epoch_fn(self, optimizer, T: int, batch_size: int, mesh=None):
        """One epoch (``make_multi_epoch_fn`` with epochs=1)."""
        return self.make_multi_epoch_fn(optimizer, T, batch_size, 1,
                                        mesh=mesh)

    def make_multi_epoch_fn(self, optimizer, T: int, batch_size: int,
                            epochs: int, mesh=None):
        """``run(generator, x_train, n_train, batches=None)`` trains
        ``epochs`` epochs and returns the per-epoch losses, (epochs,).

        Per epoch a permutation of the ``n_train`` rows is drawn from
        ``generator``; the last partial batch pads with copies of row 0 at
        loss weight 0 (dropless), so losses and gradients are those of the
        real rows. Every step draws fresh noise from ``generator``. An
        epoch's loss is the SUM of its batches' mean losses (reference
        src/mnist_exm.py:176-185). ``batches`` replaces the drawn order with
        an (epochs * n_batches, batch_size) index tensor, -1 marking pads.
        """
        if mesh is not None:
            raise NotImplementedError(
                "training over a device mesh: ROADMAP Queue 1 item 11")

        def run(generator, x_train: torch.Tensor, n_train: int,
                batches: Optional[torch.Tensor] = None) -> torch.Tensor:
            n_batches = -(-n_train // batch_size)
            if batches is None:
                pad = n_batches * batch_size - n_train
                batches = torch.cat([
                    torch.cat([torch.randperm(n_train, generator=generator),
                               torch.full((pad,), -1, dtype=torch.long)])
                    for _ in range(epochs)]).reshape(-1, batch_size)
            self.train()
            losses = []
            for idx in batches:
                valid = (idx >= 0).to(x_train.dtype).to(x_train.device)
                xb = x_train[torch.clamp(idx, min=0).to(x_train.device)]
                loss, _ = self._chain_loss(xb, T, generator=generator,
                                           valid=valid)
                self._update(optimizer, loss)
                losses.append(loss.detach())
            return torch.stack(losses).reshape(epochs, n_batches).sum(dim=1)

        return run

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
               labels=None, show_progress: bool = False,
               only_last: bool = False, step: int = 1,
               noise_factor: float = 1.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sample from ``first_x``, or from 10 uniform images drawn on the
        CPU from ``generator`` (seed 0 if none) and moved to the net's
        device. ``labels`` and ``show_progress`` are the reference's
        arguments and change nothing, as in the JAX package."""
        if first_x is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            first_x = torch.rand((10, 1, self.width, self.height),
                                 generator=generator).to(self.net.device)
        return self.sample_fn(first_x, n_iters, only_last=only_last,
                              step=step, noise_factor=noise_factor)
