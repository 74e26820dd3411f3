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
card and on the CPU. The sampler's trajectory noise draws (``traj_rng``)
come from a generator on the net's device.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from .noise import add_normal_noise_multiple
from .parallel.mesh import all_reduce_, axis_size, gather_rows, local_rows


@contextlib.contextmanager
def _net_mode(net, train: bool):
    """Run ``net`` in train or eval mode, as the JAX package passes
    ``train=True`` to every training loss and ``train=False`` to every
    sampling forward (``qiddm_tpu/diffusion.py:96, :221``), whatever mode
    the caller left it in; the caller's mode comes back afterwards. Only a
    BatchNorm model's output depends on it."""
    was = net.training
    net.train(train)
    try:
        yield
    finally:
        net.train(was)


@contextlib.contextmanager
def _buffers_kept(net):
    """Give every buffer of ``net`` its value from before the block back
    afterwards: a train-mode BatchNorm updates its running statistics in
    place, even under ``torch.no_grad``, where the JAX loss returns them as
    new variables that a loss-only call throws away
    (``qiddm_tpu/diffusion.py:303``)."""
    saved = [(b, b.detach().clone()) for b in net.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


def stack_to_grid(outp: torch.Tensor) -> torch.Tensor:
    """The reference's grid ``(I*h, b*w)`` of an ``(I, b, 1, h, w)`` stack
    of sampled batches: iterations down, images across."""
    i, b, _, h, w = outp.shape
    return outp[:, :, 0].permute(0, 2, 1, 3).reshape(i * h, b * w)


def _check_rows_independent(net, mesh, train: bool) -> None:
    """A data mesh of several ranks needs a net whose rows do not meet:
    a PCA refit on every batch, or a BatchNorm in training, would see one
    rank's rows where the JAX package's partitioner computes them over the
    whole batch. A one-rank mesh takes any net."""
    if axis_size(mesh, "data") == 1:
        return
    for m in net.modules():
        refit = getattr(m, "down", None) == "pca" and not getattr(
            m, "pca_lazy", True)
        norm = train and "BatchNorm" in type(m).__name__
        if refit or norm:
            raise NotImplementedError(
                f"{type(m).__name__} couples the rows of a batch "
                f"({'its PCA refit' if refit else 'its batch statistics'}),"
                f" so a data mesh of {axis_size(mesh, 'data')} ranks would "
                f"change its result; run it on a one-rank mesh or without "
                f"one")


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
                    valid: Optional[torch.Tensor] = None,
                    rows: Optional[slice] = None):
        """The tau-chain training loss shared by every train path.

        Builds the noisy chain, pairs step t+1 -> t, runs the denoiser on
        the expanded batch and takes the MSE for the active goal (reference
        src/models.py:44-104). With ``valid`` (a per-row 0/1 vector), padded
        rows get zero weight and the mean normalizes by the real count.
        ``rows`` keeps only those rows of the expanded batch (a data-parallel
        rank's share): the chain is drawn whole, and the loss is their part
        of the whole batch's weighted mean. Returns (loss, (per_elem,
        recon)).
        """
        tau = T + 1
        chain = self.add_noise(generator, x_flat, tau, 3.0)  # (B*tau, P)
        c = chain.reshape(-1, tau, chain.shape[-1])
        img = (-1, 1, self.width, self.height)  # "(w h)" pixel order
        noisy = c[:, 1:, :].reshape(img)
        clean = c[:, :-1, :].reshape(img)
        row_numel = noisy[0].numel()
        if rows is not None:
            noisy, clean = noisy[rows], clean[rows]
        with _net_mode(self.net, True):
            recon = self.net(noisy)
        if self.prediction_goal == "data":
            per_elem = (recon - clean) ** 2
        else:
            per_elem = ((recon - 0.5) * 0.1 - (noisy - clean)) ** 2
        if valid is None:
            loss = per_elem.mean()
        else:
            wgt = valid.repeat_interleave(tau - 1)
            if rows is not None:
                wgt = wgt[rows]
            denom = (torch.clamp(valid.sum(), min=1.0) * (tau - 1)
                     * row_numel)
            loss = (per_elem * wgt[:, None, None, None]).sum() / denom
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

    def _dp_update(self, optimizer, xb, T: int, generator, valid,
                   mesh) -> torch.Tensor:
        """One data-parallel step over the mesh's ``data`` dim: every rank
        draws the whole batch's noise, keeps its rows of the tau-expanded
        batch (``parallel.mesh.local_rows``; a rank may have none) and
        backpropagates its part of the weighted mean; one all-reduce sums
        the gradients and the loss, so every rank steps the same Adam
        update. A parameter without a gradient on every rank keeps none,
        as in a one-process step. Returns the whole batch's loss."""
        rows = local_rows(len(xb) * T, mesh, "data")
        has_rows = rows.stop > rows.start
        optimizer.zero_grad(set_to_none=False)
        if has_rows:
            loss, _ = self._chain_loss(xb, T, generator=generator,
                                       valid=valid, rows=rows)
            loss.backward()
            loss = loss.detach()
        else:  # draw the noise all the same: the generators stay in step
            self.add_noise(generator, xb, T + 1, 3.0)
            loss = torch.zeros((), device=xb.device)
        params = [p for p in self.net.parameters() if p.requires_grad]
        # the graph, not the data, decides which parameters get a gradient,
        # so a rank with rows knows the flags on the host; an empty rank
        # reads the others' back from the device
        flags = tuple(has_rows and p.grad is not None for p in params)
        buf = torch.cat(
            [(p.grad if p.grad is not None else torch.zeros_like(p))
             .reshape(-1) for p in params]
            + [self._flags_on(flags, xb.device), loss.reshape(1)])
        all_reduce_(buf, mesh, "data")
        off, n = 0, len(params)
        if not has_rows:
            flags = (buf[-1 - n:-1] > 0).tolist()
        for i, p in enumerate(params):
            g = buf[off:off + p.numel()].view_as(p)
            off += p.numel()
            if flags[i]:
                if p.grad is None:
                    p.grad = g.clone()
                else:
                    p.grad.copy_(g)
        optimizer.step()
        return buf[-1]

    def _flags_on(self, flags: tuple, device) -> torch.Tensor:
        """The 0/1 gradient flags as a tensor on ``device``, made once a
        pattern: a copy from the host's pageable memory each step would
        wait for the step's backward kernels before the all-reduce."""
        cache = self.__dict__.setdefault("_flag_tensors", {})
        key = (flags, str(device))
        if key not in cache:
            cache[key] = torch.tensor([float(f) for f in flags],
                                      device=device)
        return cache[key]

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

        With ``mesh`` (its ``data`` dim), every rank calls ``run`` with the
        same generator seed and data: each draws the whole batch order and
        noise and trains on its rows of the tau-expanded batch
        (:meth:`_dp_update`). The losses are the one-process run's up to
        the order of the reduction; on a one-rank mesh they are its bits.
        """
        if mesh is not None:
            _check_rows_independent(self.net, mesh, train=True)

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
                if mesh is None:
                    loss, _ = self._chain_loss(xb, T, generator=generator,
                                               valid=valid)
                    self._update(optimizer, loss)
                else:
                    loss = self._dp_update(optimizer, xb, T, generator,
                                           valid, mesh)
                losses.append(loss.detach())
            return torch.stack(losses).reshape(epochs, n_batches).sum(dim=1)

        return run

    # --- the torch-style call ----------------------------------------------
    def attach_optimizer(self, optimizer):
        """Make the torch-style train call train (counterpart of
        ``qiddm_tpu/diffusion.py:261-278``).

        The reference's ``forward`` runs ``.backward()`` itself
        (src/models.py:67) and its driver steps the optimizer around it:
        ``opt.zero_grad(); diff(x=..., T=...); opt.step()``. With
        ``optimizer`` attached, every train-mode ``diff(x=..., T=...)`` runs
        one loss, backward and ``optimizer.step()`` on the net's parameters
        and then sets every ``.grad`` to None, so the driver's own
        ``opt.step()`` finds no gradient and moves nothing (Adam skips a
        parameter whose grad is None): a verbatim reference loop trains one
        step per call. Prefer :meth:`make_train_step` or
        ``train.train_diffusion`` for new training loops."""
        self._optimizer = optimizer
        self._call_count = 0
        return self

    def _clear_grads(self, optimizer) -> None:
        optimizer.zero_grad(set_to_none=True)
        for p in self.parameters():
            p.grad = None

    def __call__(self, x=None, generator: Optional[torch.Generator] = None,
                 **kwargs):
        """Train mode: one training call on the image batch ``x`` with
        ``T`` (default 10) noise steps (``qiddm_tpu/diffusion.py:280-336``).
        Returns ``(|loss|,)``, or ``(|per_elem|, |recon|)`` with
        ``verbose=True``. With an attached optimizer the call steps it; its
        noise comes from ``generator``, by default a CPU generator seeded
        with the number of earlier calls (the JAX call's
        ``PRNGKey(call_count)``). Without one it raises ``RuntimeError``,
        unless ``loss_only=True``: then it returns the loss alone, noise
        from seed 0 unless ``generator`` is given, and moves nothing: no
        parameter, and no buffer (a BatchNorm's running statistics).

        Eval mode: ``self.sample(first_x=x, **kwargs)``."""
        if not self.training:
            return self.sample(first_x=x, generator=generator, **kwargs)
        T = int(kwargs.get("T", 10))
        x_flat = torch.as_tensor(x, dtype=torch.float32).reshape(
            len(x), -1).to(self.net.device)
        optimizer = getattr(self, "_optimizer", None)
        if optimizer is None:
            if not kwargs.get("loss_only", False):
                raise RuntimeError(
                    "Diffusion called in train mode without an attached "
                    "optimizer: unlike the reference (whose forward calls "
                    ".backward() internally, src/models.py:67), this would "
                    "return a loss and train NOTHING. Either "
                    "diff.attach_optimizer(torch.optim.Adam("
                    "diff.parameters(), lr)) to make this call step the "
                    "parameters, pass loss_only=True for pure loss "
                    "evaluation, or use train_diffusion()/"
                    "make_train_step() for real training loops.")
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            with torch.no_grad(), _buffers_kept(self.net):
                loss, (per_elem, recon) = self.loss_fn(x_flat, T,
                                                       generator=generator)
        else:
            if generator is None:
                generator = torch.Generator().manual_seed(self._call_count)
            self._call_count += 1
            loss, (per_elem, recon) = self.loss_fn(x_flat, T,
                                                   generator=generator)
            self._clear_grads(optimizer)
            loss.backward()
            optimizer.step()
            # the driver's own opt.step() after this call must find no grad
            self._clear_grads(optimizer)
        if kwargs.get("verbose", False):
            return per_elem.detach().abs(), recon.detach().abs()
        return (loss.detach().abs(),)

    forward = __call__

    # --- sampling -----------------------------------------------------------
    @torch.no_grad()
    def _denoise_scan(self, first_x: torch.Tensor, n_iters: int,
                      noise_factor: float, traj_rng=None):
        """The denoise loop shared by every sampling entry point; returns
        (last image batch, list of every iteration's batch). With
        ``traj_rng`` (the trajectory noise backend's random source, for a
        net with ``noise_trajectories``) every iteration draws fresh values
        from it (``qiddm_tpu/diffusion.py:203-230``)."""
        x = first_x
        xs = []
        with _net_mode(self.net, False):
            for _ in range(n_iters):
                pred = (self.net(x) if traj_rng is None
                        else self.net(x, traj_rng=traj_rng))
                if self.prediction_goal == "data":
                    x = pred
                else:
                    x = torch.clamp(x - (pred - 0.5) * 0.1 * noise_factor,
                                    0.0, 1.0)
                xs.append(x)
        return x, xs

    def _stack(self, first_x, n_iters, noise_factor, traj_rng, mesh,
               only_last: bool):
        """The (iters+1, b, ...) stack of the start and every iteration, or
        the last batch alone. With ``mesh``, the image batch splits over its
        ``data`` dim (``parallel.mesh.local_rows``), each rank denoises its
        rows with the replicated parameters, and one all-gather gives every
        rank the whole result."""
        if mesh is None:
            last, xs = self._denoise_scan(first_x, n_iters, noise_factor,
                                          traj_rng)
            return last if only_last else torch.stack([first_x] + xs)
        _check_rows_independent(self.net, mesh, train=False)
        if traj_rng is not None and axis_size(mesh, "data") > 1:
            raise NotImplementedError(
                "trajectory sampling over a data mesh of several ranks: "
                "each rank would draw its rows' branches apart from the "
                "one-process draws; sample on a one-rank mesh or without one")
        n = first_x.shape[0]
        mine = first_x[local_rows(n, mesh, "data")]
        if mine.shape[0]:
            last, xs = self._denoise_scan(mine, n_iters, noise_factor,
                                          traj_rng)
            local = last if only_last else torch.stack([mine] + xs)
        else:
            local = (mine if only_last
                     else mine[None].expand(n_iters + 1, *mine.shape))
        return gather_rows(local, n, mesh, "data", dim=0 if only_last else 1)

    def sample_fn(self, first_x: torch.Tensor, n_iters: int, *,
                  only_last: bool = False, step: int = 1,
                  noise_factor: float = 1.0, traj_rng=None,
                  mesh=None) -> torch.Tensor:
        """first_x: (b, 1, w, h). Returns the last batch (``only_last``) or
        the reference's grid ``(iters*h, b*w)`` of the start and every
        ``step``-th iteration. ``mesh``: data-parallel sampling over its
        ``data`` dim (:meth:`_stack`)."""
        out = self._stack(first_x, n_iters, noise_factor, traj_rng, mesh,
                          only_last)
        if only_last:
            return out
        return stack_to_grid(torch.cat([out[:1], out[1:][::step]]))

    def sample_stack_fn(self, first_x: torch.Tensor, n_iters: int, *,
                        noise_factor: float = 1.0, traj_rng=None,
                        mesh=None) -> torch.Tensor:
        """The raw (iters+1, b, 1, h, w) stack of the start and every
        iteration."""
        return self._stack(first_x, n_iters, noise_factor, traj_rng, mesh,
                           False)

    def sample(self, n_iters: int, first_x: Optional[torch.Tensor] = None,
               labels=None, show_progress: bool = False,
               only_last: bool = False, step: int = 1,
               noise_factor: float = 1.0,
               generator: Optional[torch.Generator] = None,
               traj_rng: Optional[torch.Generator] = None,
               mesh=None) -> torch.Tensor:
        """Sample from ``first_x``, or from 10 uniform images drawn on the
        CPU from ``generator`` (seed 0 if none) and moved to the net's
        device. ``labels`` and ``show_progress`` are the reference's
        arguments and change nothing, as in the JAX package. ``traj_rng``,
        a generator on the net's device, feeds the trajectory noise backend
        of a net with ``noise_trajectories``: the same seed gives the same
        samples. ``mesh`` splits the batch over its ``data`` dim, every rank
        calling with the same arguments and getting the whole result."""
        if first_x is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            first_x = torch.rand((10, 1, self.width, self.height),
                                 generator=generator).to(self.net.device)
        return self.sample_fn(first_x, n_iters, only_last=only_last,
                              step=step, noise_factor=noise_factor,
                              traj_rng=traj_rng, mesh=mesh)
