"""Standalone sampling / serving driver (counterpart of
``qiddm_tpu/cli/sample.py``).

Loads a checkpoint (the JAX package's pickle layout, or the ``.dcp``
directory that ``--ckpt-backend orbax`` writes; qiddm_tpu_torch/ckpt.py)
and generates images on the chosen device:

  python -m qiddm_tpu_torch.cli.sample --ckpt QIDDM_LL_noise=6_L=14_N=2_4.pt \
      --model QIDDM_LL_noise 784 6 14 2 --img_size 28 \
      --n 16 --iters 15 --device cuda --format npz --out samples/

``--device`` defaults to ``cuda`` and raises when the process has no CUDA
device; ``--device cpu`` runs the plain PyTorch path. ``--format``
defaults to ``both`` (``samples.npz`` and a PNG an image), as the JAX
package's sampling CLI does; the PNGs need matplotlib, so a host without
it passes ``--format npz``.

AOT serving (``qiddm_tpu_torch/export.py``), with the JAX CLI's rules:

  python -m qiddm_tpu_torch.cli.sample --ckpt ... --model ... --n 16 \
      --iters 15 --export s.qta            # writes the artifact and exits
  python -m qiddm_tpu_torch.cli.sample --from-export s.qta --n 16

``--export-batches 1,8,64`` writes a bucketed bundle that serves any
``--n``; ``--export-platforms cuda`` with ``--device cpu`` emits the card's
artifact from a CPU host. ``--from-export`` replaces ``--model``/``--ckpt``,
pins the iterations and noise factor the artifact was exported with, and
raises unless ``--device`` names the artifact's device.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np
import torch

from .. import export as export_mod
from ..ckpt import load_variables
from ..config import resolve_device
from ..diffusion import Diffusion
from . import common


def parse_args(argv):
    p = argparse.ArgumentParser(description="QDDM sampling / serving "
                                            "(PyTorch port)")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--model", type=str, nargs="+", default=None,
                   help="Model name and ctor params (as in the training CLI)")
    p.add_argument("--img_size", type=int, default=28)
    p.add_argument("--n", type=int, default=16, help="images to generate")
    p.add_argument("--iters", type=int, default=15, help="denoise iterations")
    p.add_argument("--target", type=str, default="data")
    p.add_argument("--noise_factor", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="samples")
    p.add_argument("--format", choices=["png", "npz", "both"], default="both",
                   help="png needs matplotlib")
    p.add_argument("--batches", type=int, default=1,
                   help="generate this many batches (throughput reporting)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when none is present")
    p.add_argument("--export", type=str, default=None, metavar="PATH",
                   help="write an AOT serving artifact (torch.export; "
                        "qiddm_tpu_torch/export.py) for this model+ckpt at "
                        "the given --n/--iters, then exit")
    p.add_argument("--export-platforms", type=str, default=None,
                   help="the artifact's device, 'cuda' or 'cpu' (default: "
                        "--device); 'cuda' from a CPU host emits the "
                        "card's artifact")
    p.add_argument("--export-batches", type=str, default=None,
                   help="comma list of batch sizes (e.g. '1,8,64') to "
                        "export a BUCKETED bundle instead of the single "
                        "--n batch; --from-export then serves any request "
                        "size")
    p.add_argument("--from-export", type=str, default=None, metavar="PATH",
                   help="serve from an AOT artifact instead of "
                        "--model/--ckpt (no model code or checkpoint "
                        "needed)")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="not ported: serving over a device mesh")
    return p.parse_args(argv)


def _load_artifact(args, device):
    """The sampler of ``--from-export``, after the JAX CLI's checks and
    the device's: ``--device`` must name the artifact's device."""
    if args.model or args.ckpt:
        raise SystemExit("--from-export replaces --model/--ckpt")
    if args.export:
        raise SystemExit("--export needs --model/--ckpt; it cannot "
                         "re-export a loaded artifact")
    if args.export_batches:
        raise SystemExit("--export-batches selects the bucket ladder at "
                         "export time; a loaded bundle already carries its "
                         "ladder")
    print("note: --iters/--noise_factor were pinned at export time; the "
          "CLI values do not apply to the artifact", file=sys.stderr)
    blob = pathlib.Path(args.from_export).read_bytes()
    where = export_mod.artifact_device(blob)
    if where.type != device.type:
        raise SystemExit(f"--from-export {args.from_export} runs on {where} "
                         f"and --device is {device}; pass --device "
                         f"{where.type}")
    if export_mod.is_bundle(blob):
        return export_mod.load_sampler_bundle(blob)
    return export_mod.load_sampler(blob)


def _export(args, diff) -> None:
    platforms = (tuple(args.export_platforms.split(","))
                 if args.export_platforms else None)
    if args.export_batches:
        batches = [int(b) for b in args.export_batches.split(",")]
        blob = export_mod.export_sampler_bundle(
            diff, batches=batches, n_iters=args.iters,
            noise_factor=args.noise_factor, platforms=platforms)
        what = f"bucketed bundle batches={sorted(set(batches))}"
    else:
        blob = export_mod.export_sampler(
            diff, batch=args.n, n_iters=args.iters,
            noise_factor=args.noise_factor, platforms=platforms)
        what = f"batch={args.n}"
    pathlib.Path(args.export).write_bytes(blob)
    print(f"exported AOT sampler -> {args.export} ({len(blob)/1e6:.2f} MB, "
          f"{what}, iters={args.iters}, device "
          f"{export_mod.artifact_device(blob)})")


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.mesh_devices:
        raise SystemExit("--mesh-devices: data-parallel serving over a mesh "
                         "(ROADMAP Queue 1 item 11, its mesh half) is not "
                         "ported to qiddm_tpu_torch yet")
    device = resolve_device(args.device)
    s = args.img_size
    sampler = diff = None
    if args.from_export:
        sampler = _load_artifact(args, device)
    else:
        if not (args.model and args.ckpt):
            raise SystemExit("need --model and --ckpt (or --from-export)")
        if args.export_batches and not args.export:
            raise SystemExit("--export-batches selects the bucket ladder of "
                             "an AOT bundle; it needs --export PATH")
        net = common.build_model(list(args.model), seed=args.seed,
                                 device=device)
        try:
            load_variables(net, args.ckpt)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        diff = Diffusion(net=net, prediction_goal=args.target,
                         shape=(s, s)).eval()
    if args.export:
        _export(args, diff)
        return None

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator().manual_seed(args.seed)
    all_imgs = []
    t_first = t_rest = None
    for b in range(args.batches):
        first_x = (torch.rand((args.n, 1, s, s), generator=gen) * 0.75
                   + 0.5).to(device)
        t0 = time.perf_counter()
        if sampler is not None:
            imgs = sampler(first_x)
        else:
            imgs = diff.sample(n_iters=args.iters, first_x=first_x,
                               only_last=True,
                               noise_factor=args.noise_factor)
        imgs = imgs.cpu().numpy()  # waits for the device
        dt = time.perf_counter() - t0
        if b == 0:
            t_first = dt
        else:
            t_rest = (t_rest or 0) + dt
        all_imgs.append(imgs)
    imgs = np.concatenate(all_imgs)

    if args.format in ("npz", "both"):
        np.savez_compressed(out_dir / "samples.npz", images=imgs)
    if args.format in ("png", "both"):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for i in range(len(imgs)):
            plt.imsave(out_dir / f"sample_{i:04d}.png", imgs[i, 0],
                       cmap="gray")
    iters = ("artifact-pinned iters" if sampler is not None
             else f"{args.iters} iters")
    msg = (f"generated {len(imgs)} images ({iters}) on {device} "
           f"-> {out_dir}; first batch {t_first:.3f}s (incl one-time set-up)")
    if args.batches > 1:
        steady = (args.batches - 1) * args.n / t_rest
        msg += f", steady {steady:.1f} images/s"
    print(msg)
    return imgs


if __name__ == "__main__":
    main()
