"""The mesh's checks: the sharded statevector, data-parallel training and
data-parallel sampling, each held against the same work without a mesh,
which every rank also runs, and timed on the host clock beside it. The
check functions take the mesh they run on: ``chip_smoke.py`` phase 49
calls them on its one-rank NCCL mesh, and :func:`main` on the ranks that
``torchrun`` starts.

    torchrun --nproc-per-node 4 -m qiddm_tpu_torch.tools.mesh_check
    torchrun --nproc-per-node 4 -m qiddm_tpu_torch.tools.mesh_check \\
        --device cpu --wires 6 --L 2 --model QIDDM_LL_noise 64 4 2 1

Defaults: the engine's block at QIDDM_LL_noise(784, 16, 14, 2)'s width
(16 wires, L 14, k 2, 10 rows; with 4 ranks 2 of its bits select the
rank, each rank holds 2**14 amplitudes a row), and QIDDM_LL_noise(784, 6,
14, 2) trained at batch 1, tau 10 (10 rows a step, split 3, 3, 3, 1 over
4 ranks) and sampled 16 x 15.

Bounds: the route within 1e-4 and its gradients within 2e-3 relative of
the route without a mesh (on the card #11/#12); the sampled images within
1e-4; every training step's loss from the same weights (lr 0) within 1e-5
relative, and the last step's gradients within 1e-4 (the rows' sums in
another order, a kernel at another batch). The losses of a run at the
model's learning rate are printed beside, not held: Adam's first steps
move a weight by about lr whatever the size of its gradient, so an entry
within rounding of zero can move it either way. The witness of that is a
run with no mesh at all (``row_split``): one device, the loss the sum of
the parts a ``split``-rank mesh would take, each part's gradient summed by
autograd; it parts from the plain run as the mesh does.

Rank 0 prints one JSON line: the ranks, the first all-reduce's time on the
new group (the communicator's set-up), each check's error and bound, the
times, the collectives one mesh step of the route issues, and the card's
name and power limit (``nvidia-smi``). Exits 1 when a check fails. With
no launcher it runs on one rank.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..cli.common import DEFAULT_LRS, build_model
from ..config import resolve_device
from ..diffusion import Diffusion
from ..parallel import make_mesh
from ..parallel.distributed import shutdown
from ..parallel.mesh import (
    COLLECTIVES,
    all_reduce_,
    axis_size,
    reset_collectives,
    split_rows,
)
from ..sim import engine
from ..train import train_diffusion_scan
from .common import card

ROUTE_TOL, GRAD_TOL, SAMPLE_TOL = 1e-4, 2e-3, 1e-4
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-5, 1e-4
# the route's block (k, rows) and its timed steps; training's tau; the
# sampled batch and its iterations; the seed of every input and weight
K, ROWS, STEPS, TAU, SAMPLE, ITERS, SEED = 2, 10, 3, 10, 16, 15, 0


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--wires", type=int, default=16)
    p.add_argument("--L", type=int, default=14)
    p.add_argument("--model", nargs="+",
                   default=["QIDDM_LL_noise", "784", "6", "14", "2"])
    p.add_argument("--images", type=int, default=8)
    p.add_argument("--epochs", type=int, default=1)
    return p.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rel(got, want) -> float:
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def first_all_reduce_ms(mesh, dev) -> float:
    """One all-reduce on ``mesh``'s ``data`` dim, timed to the device's
    end: on a new group it sets the communicator up, which later work then
    does not pay. The collective counts are reset after it."""
    t0 = time.perf_counter()
    all_reduce_(torch.zeros(1, device=dev), mesh, "data")
    _sync(dev)
    reset_collectives()
    return (time.perf_counter() - t0) * 1e3


# --- the engine's route ------------------------------------------------------

def route_inputs(wires: int, L: int, dev) -> tuple:
    """(x, w, coeff): ROWS rows, (L, K, wires, 3) weights and the loss's
    coefficients, seeded."""
    gen = torch.Generator().manual_seed(SEED)
    w = (torch.randn((L, K, wires, 3), generator=gen) * 0.4).to(dev)
    x = torch.rand((ROWS, wires), generator=gen).to(dev)
    coeff = torch.randn((ROWS, 2**wires), generator=gen).to(dev)
    return x, w, coeff


def _block(x, w, coeff, mesh, counts=None, **kw):
    """(values, gradients of sum(coeff * out) to (w, x), the launches
    ``counts`` reads, or None)."""
    if counts:
        counts()
    w = w.detach().clone().requires_grad_(True)
    x = x.detach().clone().requires_grad_(True)
    out = engine.reupload_block(x, w, mesh=mesh, **kw)
    grads = torch.autograd.grad((coeff[:, :out.shape[1]] * out).sum(),
                                (w, x))
    _sync(x.device)
    return out.detach(), grads, counts() if counts else None


def check_route(mesh, dev, wires: int, L: int, readouts=("expvalz", "probs"),
                counts=None, **gates) -> dict:
    """Each readout of the block on ``mesh`` against the route without one:
    the values' largest difference (``err``), the gradients' relative one
    (``grad_rel``) and, with ``counts`` (a call that returns the kernel
    launches since its last call), each route's launches. ``gates`` go to
    ``engine.reupload_block`` (``encode``, ``imprimitive``)."""
    x, w, coeff = route_inputs(wires, L, dev)
    out = {}
    for readout in readouts:
        got, g_got, c_mesh = _block(x, w, coeff, mesh, counts,
                                    readout=readout, **gates)
        want, g_want, c_one = _block(x, w, coeff, None, counts,
                                     readout=readout, **gates)
        out[readout] = {"err": float((got - want).abs().max()),
                        "grad_rel": _rel(g_got, g_want),
                        "launches": {"mesh": c_mesh, "one_device": c_one}}
    return out


def route_rates(mesh, dev, wires: int, L: int) -> dict:
    """The collectives of one forward and backward of the expvalz block on
    ``mesh``, and its steps/s on the host clock against the route without
    a mesh (STEPS each, after a warm one)."""
    x, w, coeff = route_inputs(wires, L, dev)
    reset_collectives()
    _block(x, w, coeff, mesh, readout="expvalz")
    out = {"collectives_a_step": dict(COLLECTIVES)}
    for name, m in (("mesh", mesh), ("one_device", None)):
        _block(x, w, coeff, m, readout="expvalz")
        t0 = time.perf_counter()
        for _ in range(STEPS):
            _block(x, w, coeff, m, readout="expvalz")
        out[f"steps_per_s_{name}"] = STEPS / (time.perf_counter() - t0)
    return out


# --- training ----------------------------------------------------------------

class _RowSplit(Diffusion):
    """One device and no mesh: each step's loss is the sum of the ``split``
    parts that the ranks of a ``split``-rank data mesh take (the same draws
    replayed for each part), so autograd sums the parts' gradients and
    nothing else differs from the plain run."""

    def __init__(self, net, shape, split: int):
        super().__init__(net, shape=shape)
        self.split = split

    def _chain_loss(self, x_flat, T, *, generator, valid=None, rows=None):
        state = generator.get_state()
        n, loss = len(x_flat) * T, 0.0
        for rank in range(self.split):
            part = split_rows(n, self.split, rank)
            if part.stop > part.start:
                generator.set_state(state)
                loss = loss + super()._chain_loss(
                    x_flat, T, generator=generator, valid=valid,
                    rows=part)[0]
        return loss, None


def _diffusion(model, side, dev, split=None):
    net = build_model(list(model), seed=SEED, device=dev)
    if split is None:
        return Diffusion(net, shape=(side, side))
    return _RowSplit(net, (side, side), split)


def _fixed_weights(model, side, x, mesh, dev):
    """Every step's loss from the seeded weights (Adam at lr 0 moves
    nothing), one image a step, and the last step's gradients."""
    diff = _diffusion(model, side, dev)
    n = len(x)
    run = diff.make_multi_epoch_fn(
        torch.optim.Adam(diff.parameters(), lr=0.0), TAU, 1, n, mesh=mesh)
    losses = run(torch.Generator().manual_seed(SEED), x, 1,
                 batches=torch.arange(n).reshape(n, 1))
    return losses, [p.grad for p in diff.net.parameters()]


def check_training(mesh, dev, model, x: torch.Tensor, epochs: int,
                   split=None, counts=None) -> dict:
    """``model`` trained on the host's images ``x`` (n, side**2) at batch
    1, tau TAU, its learning rate, ``epochs`` epochs, on ``mesh`` and
    without it.

    Held: ``fixed_weights`` (every step's loss from the same weights, and
    the last gradients). Printed: ``run`` (the epoch losses of each run,
    and how far the mesh and the witness part from the plain run, and from
    each other); ``bit_equal`` (losses and weights, mesh against none);
    ``step_ms`` (the runs' time a step, host clock, taken in turns: none,
    mesh, mesh, none; the mesh runs' collectives and, with ``counts``,
    every run's launches). The witness splits into ``split`` parts (the
    mesh's ``data`` size if None)."""
    side = int(round(int(model[1]) ** 0.5))
    (l1, g1), (lm, gm) = (_fixed_weights(model, side, x.to(dev), m, dev)
                          for m in (None, mesh))
    lr = DEFAULT_LRS[model[0]]
    split = axis_size(mesh, "data") if split is None else split
    runs = {name: [] for name in ("one_device", "mesh", "row_split")}
    for name in ("one_device", "mesh", "mesh", "one_device", "row_split"):
        diff = _diffusion(model, side, dev,
                          split if name == "row_split" else None)
        if counts:
            counts()
        reset_collectives()
        losses, wall = train_diffusion_scan(
            diff, x, epochs=epochs, batch_size=1, lr=lr, T=TAU, key=SEED,
            mesh=mesh if name == "mesh" else None, warmup=False)
        runs[name].append({
            "losses": losses, "ms": wall / (epochs * len(x)) * 1e3,
            "weights": [p.detach().clone() for p in diff.net.parameters()],
            "launches": counts() if counts else None,
            "collectives": dict(COLLECTIVES)})
    one, mesh_run, witness = (runs[k][0] for k in runs)

    def part(a, b) -> float:
        return float(np.abs(a["losses"] - b["losses"]).max()
                     / np.abs(b["losses"]).max())

    return {
        "fixed_weights": {
            "loss_rel": float((lm - l1).abs().max() / l1.abs().max()),
            "grad_rel": _rel(gm, g1)},
        "run": {"losses": {k: v[0]["losses"].tolist()
                           for k, v in runs.items()},
                "split": split, "mesh_rel": part(mesh_run, one),
                "row_split_rel": part(witness, one),
                "mesh_to_row_split_rel": part(mesh_run, witness)},
        "bit_equal": all(
            np.array_equal(r["losses"], one["losses"])
            and all(torch.equal(a, b)
                    for a, b in zip(r["weights"], one["weights"]))
            for r in runs["mesh"] + runs["one_device"]),
        "step_ms": {k: [r["ms"] for r in v] for k, v in runs.items()},
        "collectives": mesh_run["collectives"],
        "launches": {k: [r["launches"] for r in v] for k, v in runs.items()},
    }


# --- sampling ----------------------------------------------------------------

def check_sampling(mesh, dev, model, counts=None) -> dict:
    """SAMPLE images ITERS iterations from seeded starts, on ``mesh`` and
    without it: the largest difference, the images/s of each (host clock,
    after a warm run) and, with ``counts``, each timed run's launches."""
    side = int(round(int(model[1]) ** 0.5))
    diff = _diffusion(model, side, dev).eval()
    first = torch.rand((SAMPLE, 1, side, side),
                       generator=torch.Generator().manual_seed(
                           SEED + 2)).to(dev)
    out, rates, launches = {}, {}, {}
    for name, m in (("one_device", None), ("mesh", mesh)):
        diff.sample(ITERS, first_x=first, only_last=True, mesh=m)
        _sync(dev)
        if counts:
            counts()
        t0 = time.perf_counter()
        out[name] = diff.sample(ITERS, first_x=first, only_last=True,
                                mesh=m)
        _sync(dev)
        rates[name] = SAMPLE / (time.perf_counter() - t0)
        launches[name] = counts() if counts else None
    return {"err": float((out["mesh"] - out["one_device"]).abs().max()),
            "images_per_s": rates, "launches": launches}


def passed(route: dict, training: dict, sampling: dict) -> bool:
    return (all(r["err"] <= ROUTE_TOL and r["grad_rel"] <= GRAD_TOL
                for r in route.values())
            and training["fixed_weights"]["loss_rel"] <= STEP_LOSS_TOL
            and training["fixed_weights"]["grad_rel"] <= STEP_GRAD_TOL
            and sampling["err"] <= SAMPLE_TOL)


def main(argv=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    formed = not dist.is_initialized()
    mesh = make_mesh(None, ("data",), device=device)
    rank = dist.get_rank()
    side = int(round(int(args.model[1]) ** 0.5))
    x = torch.as_tensor(np.random.default_rng(SEED + 1).uniform(
        size=(args.images, side * side)).astype(np.float32))
    try:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if device.type == "cuda" else device)
        report = {"ranks": dist.get_world_size(), "device": str(dev),
                  "card": card(dev),
                  "first_all_reduce_ms": first_all_reduce_ms(mesh, dev),
                  "route": check_route(mesh, dev, args.wires, args.L),
                  "route_rates": route_rates(mesh, dev, args.wires, args.L),
                  "training": check_training(mesh, dev, args.model, x,
                                             args.epochs),
                  "sampling": check_sampling(mesh, dev, args.model)}
    finally:
        if formed:
            shutdown()
    report["ok"] = passed(report["route"], report["training"],
                          report["sampling"])
    if rank == 0:
        print(json.dumps(report, default=lambda o: None))
    return report


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
