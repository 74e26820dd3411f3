"""Steady sampled images/s of the live sampler, as ``cli.sample`` serves:
a model with seeded weights, ``--batch`` start images, ``--iters``
denoise iterations a batch, ``--reps`` batches timed on the host clock to a
synchronise after two warm ones, the median wall. With ``--artifact`` it
also exports the sampler (``qiddm_tpu_torch.export``) and times the
loaded artifact in turns with the live sampler (live, artifact, artifact,
live). With ``--against DIR`` it loads another checkout's package
(``DIR/qiddm_tpu_torch``, under another name, in the same process) and
times that checkout's live sampler on the same weights and start images
in turns with this one's, which holds the host's drift out of the
comparison better than two processes do.

The live path's entries are the same in earlier checkouts of the port, so
the same script also times another checkout's sampler alone when that
checkout comes first on the path (the artifact needs this one's):

    python -m qiddm_tpu_torch.tools.serving_rate --artifact --against <dir>
    PYTHONPATH=<other checkout> python3 qiddm_tpu_torch/tools/serving_rate.py

It prints one JSON line: the package it timed, the card and its power
limit, the images/s and the walls. ``--device cpu`` runs the plain
versions (a check that the script runs, not a device rate).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import pathlib
import statistics
import sys
import time

import numpy as np
import torch

import qiddm_tpu_torch
from qiddm_tpu_torch.cli.common import build_model
from qiddm_tpu_torch.diffusion import Diffusion
from qiddm_tpu_torch.tools.common import card


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _package_at(root: str):
    """``root/qiddm_tpu_torch`` imported as ``against_qiddm_tpu_torch``
    (the package imports itself relatively), beside this one."""
    alias = "against_qiddm_tpu_torch"
    path = pathlib.Path(root).resolve() / "qiddm_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, path / "__init__.py", submodule_search_locations=[str(path)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(f"{alias}.cli.common").build_model,
            importlib.import_module(f"{alias}.diffusion").Diffusion, path)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", nargs="+",
                   default=["QIDDM_LL_noise", "784", "6", "14", "2"])
    p.add_argument("--side", type=int, default=28)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=15)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--artifact", action="store_true")
    p.add_argument("--against", default=None, metavar="DIR",
                   help="another checkout whose live sampler is timed in "
                        "turns with this one's")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    device = torch.device(args.device)
    net = build_model(args.model, seed=args.seed, device=device)
    diff = Diffusion(net=net, shape=(args.side, args.side)).eval()
    rng = np.random.default_rng(args.seed)
    x = torch.as_tensor(
        (rng.uniform(size=(args.batch, 1, args.side, args.side)) * 0.75
         + 0.5).astype(np.float32), device=device)
    calls = {"live": lambda: diff.sample_fn(x, args.iters, only_last=True)}
    extra = {}
    if args.artifact:
        from qiddm_tpu_torch import export

        served = export.load_sampler(export.export_sampler(
            diff, batch=args.batch, n_iters=args.iters))
        calls["artifact"] = lambda: served(x)
    if args.against:
        build, other_diffusion, path = _package_at(args.against)
        other = other_diffusion(
            net=build(args.model, seed=args.seed, device=device),
            shape=(args.side, args.side)).eval()
        calls["against"] = lambda: other.sample_fn(x, args.iters,
                                                   only_last=True)
        extra["against"] = str(path)
    outs = {}
    for name, call in calls.items():
        call()
        outs[name] = call()
    _sync(device)
    extra["max_abs_diff"] = {
        name: float((out - outs["live"]).abs().max())
        for name, out in outs.items() if name != "live"}
    # in turns: live, the others, the others in reverse, live
    others = [name for name in calls if name != "live"]
    order = ["live", *others, *others[::-1], "live"]
    walls = {name: [] for name in calls}
    for _ in range(args.reps // 2 if others else args.reps):
        for name in order:
            t0 = time.perf_counter()
            calls[name]()
            _sync(device)
            walls[name].append(time.perf_counter() - t0)
    out = {"tool": "serving_rate",
           "package": str(qiddm_tpu_torch.__file__),
           "card": card(device), "model": args.model, "batch": args.batch,
           "iters": args.iters, **extra,
           **{f"{name}_images_per_s": args.batch / statistics.median(w)
              for name, w in walls.items()},
           "walls_ms": {name: [round(1e3 * t, 4) for t in w]
                        for name, w in walls.items()}}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
