"""Learning-rate sweeps with synchronized successive halving (counterpart of
``qiddm_tpu/sweep.py``), replacing the reference's Ray Tune.

Reference: src/mnist_ray.py / src/fashion_ray.py: Ray Tune 2.4 with an
AsyncHyperBand scheduler, one trial at a time (max_concurrent_trials=1,
src/mnist_ray.py:213), each trial reporting its final ``loss`` and
``ssim`` and saving a checkpoint named with both (src/mnist_ray.py:136-151).

Here the trials of one architecture train one after another on the card,
each through ``Diffusion.make_multi_epoch_fn`` with its own seed, learning
rate, Adam state and random draws; the JAX package trains them all in one
vmapped program. Synchronized successive halving stands in for
AsyncHyperBand: every live trial trains to a rung, is scored by SSIM, the
best fraction goes on, and each survivor's Adam moments carry over to its
next segment. A trial stopped at a rung keeps the metrics of its last
rung. The artifacts keep the tune_results layout: a directory per trial
with ``params.json``, ``result.json``, ``progress.csv`` and, for the
trials that finished, a checkpoint named with the final loss and SSIM.

Trial t is built by ``make_net(seed + t)`` and draws its batch order and
noise from a CPU generator seeded from ``(seed, t)``, carried across its
segments; so a trial gives the same weights whether it trains in a sweep
or alone (``trial_generator``).
"""

from __future__ import annotations

import json
import pathlib
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from . import metrics
from .ckpt import export_jax_variables, save_checkpoint, save_dcp
from .diffusion import Diffusion


@dataclass
class SweepResult:
    lrs: List[float]
    loss_curves: np.ndarray        # (n_trials, epochs)
    final_loss: np.ndarray         # (n_trials,)
    ssim: np.ndarray               # (n_trials,)
    best_by_loss: int = 0
    best_by_ssim: int = 0
    trial_dirs: List[str] = field(default_factory=list)


def trial_generator(seed: int, trial: int) -> torch.Generator:
    """Trial ``trial``'s source of batch orders and noise: a CPU generator
    seeded from ``(seed, trial)``."""
    state = np.random.SeedSequence([seed, trial]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def sweep_lr(make_net: Callable[[int], object], lrs: Sequence[float],
             x_train, *, shape, epochs: int, batch_size: int, T: int,
             prediction_goal: str = "data", first_x=None,
             sample_iters: int = 5, real_for_ssim=None, seed: int = 0,
             local_dir: Optional[str] = None, exp_name: str = "sweep",
             mesh=None, rungs: Optional[List[float]] = None,
             ckpt_backend: str = "pt") -> SweepResult:
    """Train ``len(lrs)`` trials of one architecture, trial t from
    ``make_net(seed + t)`` (a denoiser shim on its device) at ``lrs[t]``.

    ``rungs``: successive halving, either keep-fractions applied at evenly
    spaced epochs or ``(epoch, keep_frac)`` pairs (``asha_rungs(epochs)``
    gives AsyncHyperBand's grace 1, reduction 4). ``first_x`` (the
    sampler's start images for the SSIM) defaults to 15 uniform images
    drawn from ``seed + 7``. ``ckpt_backend`` "orbax" writes each finished
    trial's checkpoint as a DCP directory (``ckpt.save_dcp``). ``mesh``
    (trials over a device mesh) is not ported and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "sweep trials over a device mesh: ROADMAP Queue 1 item 11")
    if ckpt_backend not in ("pt", "orbax"):
        raise ValueError(f"unknown checkpoint backend {ckpt_backend!r}")
    n_trials = len(lrs)
    h, w = shape
    nets = [make_net(seed + t) for t in range(n_trials)]
    device = nets[0].device
    x = torch.as_tensor(np.asarray(x_train), dtype=torch.float32).reshape(
        -1, h * w).to(device)
    n_train = len(x)
    bs = min(batch_size, n_train)
    diffs = [Diffusion(net, prediction_goal=prediction_goal, shape=shape)
             for net in nets]
    optimizers = [torch.optim.Adam(d.parameters(), lr=float(lr))
                  for d, lr in zip(diffs, lrs)]
    gens = [trial_generator(seed, t) for t in range(n_trials)]
    if first_x is None:
        # 15 start images, the reference sweep's (src/mnist_ray.py:132)
        first_x = torch.rand((15, 1, h, w),
                             generator=torch.Generator().manual_seed(
                                 seed + 7)) * 0.75 + 0.5
    first_x = torch.as_tensor(first_x).to(device)

    # a single trial is never dropped at a rung: it trains in one segment
    plan = _rung_plan(epochs, rungs if n_trials > 1 else None)
    loss_curves = np.zeros((n_trials, epochs), np.float32)
    last_epoch = np.zeros((n_trials,), np.int64)
    ssims = np.zeros((n_trials,), np.float32)
    live = np.arange(n_trials)
    epochs_done = 0
    t_start = time.time()
    for seg_epochs, keep_frac in plan:
        t0 = time.perf_counter()
        for t in live:
            run = diffs[t].make_multi_epoch_fn(optimizers[t], T, bs,
                                               seg_epochs)
            loss_curves[t, epochs_done:epochs_done + seg_epochs] = (
                run(gens[t], x, n_train).cpu().numpy())
        wall = time.perf_counter() - t0
        epochs_done += seg_epochs
        last_epoch[live] = epochs_done
        print(f"sweep {exp_name}: {len(live)} trial(s) trained epochs "
              f"{epochs_done - seg_epochs + 1}-{epochs_done} one after "
              f"another on {device} in {wall:.3f} s "
              f"({len(live) * seg_epochs * n_train / max(wall, 1e-9):.1f} "
              f"training images/s)")
        # every live trial's SSIM, the sweep's selection metric
        # (src/mnist_ray.py:207, mode="max")
        cur = _score_ssim([diffs[t] for t in live], first_x, sample_iters,
                          real_for_ssim, x_train, (h, w))
        ssims[live] = cur
        if keep_frac is not None and keep_frac < 1.0 and len(live) > 1:
            live = np.sort(live[_keep(cur, keep_frac)])
            print(f"sweep {exp_name}: halving at epoch {epochs_done} keeps "
                  f"trials {live.tolist()}")

    final_loss = np.asarray(
        [loss_curves[t, max(last_epoch[t] - 1, 0)] for t in range(n_trials)],
        np.float32)
    result = SweepResult(
        lrs=list(map(float, lrs)), loss_curves=loss_curves,
        final_loss=final_loss, ssim=ssims,
        best_by_loss=int(np.argmin(final_loss)),
        best_by_ssim=int(np.argmax(ssims)))
    if local_dir is not None:
        result.trial_dirs = _write_artifacts(
            local_dir, exp_name, result, {int(t): nets[t] for t in live},
            dict(batch_size=bs, epochs=epochs, T=T), t_start, last_epoch,
            ckpt_backend)
    return result


def params_count(nets) -> int:
    """The number of trials (the JAX package's counts the stacked trial
    axis of its parameters; here the trials are a list of nets)."""
    return len(nets)


def _keep(scores: np.ndarray, keep_frac: float) -> np.ndarray:
    """Positions in ``scores`` of the best ``ceil(n * keep_frac)`` (at
    least one), by ``np.argsort`` of the negated scores, as the JAX
    package picks them."""
    k = max(1, int(np.ceil(len(scores) * keep_frac)))
    return np.argsort(-scores)[:k]


def asha_rungs(epochs: int, grace: int = 1, reduction: int = 4):
    """Synchronized rungs after AsyncHyperBandScheduler's defaults
    (reference src/mnist_ray.py:207: metric=ssim, mode=max, with Ray's
    grace_period=1, reduction_factor=4): rungs at epochs
    grace * reduction^k, keeping the best 1/reduction at each.

    Returns [(epoch, keep_frac), ...] for sweep_lr(rungs=...)."""
    rungs = []
    t = grace
    while t < epochs:
        rungs.append((t, 1.0 / reduction))
        t *= reduction
    return rungs


def _rung_plan(epochs: int, rungs):
    """[(segment_epochs, keep_frac_after_segment_or_None), ...].

    ``rungs`` is either a list of keep-fractions (applied at evenly spaced
    epochs) or a list of (epoch, keep_frac) pairs (explicit rung points,
    e.g. from asha_rungs)."""
    if not rungs:
        return [(epochs, None)]
    if isinstance(rungs[0], (tuple, list)):
        plan, prev = [], 0
        for ep, keep in rungs:
            # a rung at or past the budget is dropped, not clamped: a cull
            # at the very end would stop trials that finished
            if int(ep) >= epochs or int(ep) <= prev:
                continue
            plan.append((int(ep) - prev, float(keep)))
            prev = int(ep)
        plan.append((epochs - prev, None))
        return plan
    n = len(rungs) + 1
    seg = epochs // n
    if seg == 0:
        # fewer epochs than rung points: halving untrained models would
        # cull by noise (and a dropped trial would report loss 0.0)
        return [(epochs, None)]
    plan = [(seg, rungs[i]) for i in range(len(rungs))]
    plan.append((epochs - seg * len(rungs), None))
    return plan


def _score_ssim(diffs, first_x, sample_iters, real_for_ssim, x_train,
                shape) -> np.ndarray:
    """The reference sweep's selection metric (src/mnist_ray.py:156-192),
    one value a trial: each trial samples ``sample_iters`` iterations from
    ``first_x``; its first image of the last iteration, clamped to [0, 1]
    and scaled to [0, 255], is scored by SSIM against the first real image
    (``real_for_ssim``, else the first 20 training images), min-max
    normalized and scaled to [0, 255]."""
    h, w = shape
    real = real_for_ssim if real_for_ssim is not None else x_train[:20]
    real = np.asarray(real).reshape(-1, 1, h, w).astype(np.float32)
    rmin = real.reshape(len(real), -1).min(1)[:, None, None, None]
    rmax = real.reshape(len(real), -1).max(1)[:, None, None, None]
    real = np.clip((real - rmin) / (rmax - rmin + 1e-7) * 255.0, 0.0, 255.0)
    scores = []
    for diff in diffs:
        last = diff.eval().sample_fn(first_x, sample_iters, only_last=True)
        g = torch.clamp(torch.clamp(last, 0.0, 1.0) * 255.0, 0.0, 255.0)
        gen = g[None, :1].cpu().numpy()       # (1 iteration, 1 image, 1, h, w)
        scores.append(metrics.ssim_iterations(gen, real[:1])[0])
    return np.asarray(scores, np.float32)


def _write_artifacts(local_dir, exp_name, result: SweepResult, alive: dict,
                     cfg, t_start, last_epoch, ckpt_backend: str = "pt"):
    """The tune_results layout (reference tune_results/...):
    ``<local_dir>/<exp_name>/<trial>/params.json``, ``result.json``,
    ``progress.csv``, and for each trial in ``alive`` ({trial: net}, those
    that trained every epoch) a checkpoint named with its final loss and
    SSIM, in the JAX package's layout (``.pt``) or, under ``ckpt_backend``
    "orbax", as a DCP directory (``.dcp``). ``training_iteration`` is the
    epochs a trial trained (a trial stopped at a rung stops early);
    ``time_total_s`` is the whole sweep's wall."""
    base = pathlib.Path(local_dir) / exp_name
    dirs = []
    elapsed = time.time() - t_start
    for t, lr in enumerate(result.lrs):
        td = base / f"trial_{t:05d}_lr={lr:.5f}"
        td.mkdir(parents=True, exist_ok=True)
        with open(td / "params.json", "w") as f:
            json.dump({"lr": lr, **cfg}, f, indent=2)
        rec = {
            "loss": float(result.final_loss[t]),
            "ssim": float(result.ssim[t]),
            "training_iteration": int(last_epoch[t]),
            "time_total_s": elapsed,
            "node_ip": "127.0.0.1",
            "trial_id": f"trial_{t:05d}",
            # True when a halving rung stopped this trial before the
            # full epoch budget (AsyncHyperBand's early stop)
            "early_stopped": bool(int(last_epoch[t]) < int(cfg["epochs"])),
        }
        with open(td / "result.json", "w") as f:
            f.write(json.dumps(rec) + "\n")
        with open(td / "progress.csv", "w") as f:
            f.write("training_iteration,loss\n")
            for e, v in enumerate(result.loss_curves[t][:int(last_epoch[t])]):
                f.write(f"{e + 1},{v}\n")
        if t in alive:
            net = alive[t]
            stem = (f"{net.save_name()}_"
                    f"{result.final_loss[t]:.4f}_{result.ssim[t]:.4f}")
            losses = list(map(float, result.loss_curves[t]))
            if ckpt_backend == "orbax":
                save_dcp(td / f"{stem}.dcp", export_jax_variables(net),
                         loss_values=losses, epochs=cfg["epochs"])
            else:
                save_checkpoint(td / f"{stem}.pt", export_jax_variables(net),
                                losses, cfg["epochs"])
        dirs.append(str(td))
    return dirs
