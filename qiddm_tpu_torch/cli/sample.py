"""Standalone sampling / serving driver (counterpart of
``qiddm_tpu/cli/sample.py``).

Loads a checkpoint (the JAX package's pickle layout, qiddm_tpu_torch/ckpt.py)
and generates images on the chosen device:

  python -m qiddm_tpu_torch.cli.sample --ckpt QIDDM_LL_noise=6_L=14_N=2_4.pt \
      --model QIDDM_LL_noise 784 6 14 2 --img_size 28 \
      --n 16 --iters 15 --device cuda --format npz --out samples/

``--device`` defaults to ``cuda`` and raises when the process has no CUDA
device; ``--device cpu`` runs the plain PyTorch path. ``--format``
defaults to ``both`` (``samples.npz`` and a PNG an image), as the JAX
package's sampling CLI does; the PNGs need matplotlib, so a host without
it passes ``--format npz``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np
import torch

from ..ckpt import load_checkpoint, load_jax_variables
from ..config import resolve_device
from ..diffusion import Diffusion
from . import common

# Flags of the JAX driver that the port does not serve yet.
_NOT_PORTED = {
    "export": "AOT export (ROADMAP Queue 1 item 11)",
    "export_platforms": "cross-platform AOT export (ROADMAP Queue 1 item 11)",
    "from_export": "serving from an AOT export (ROADMAP Queue 1 item 11)",
    "export_batches": "bucketed AOT export (ROADMAP Queue 1 item 11)",
    "mesh_devices": "data-parallel serving over a mesh "
                    "(ROADMAP Queue 1 item 11)",
}


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
    p.add_argument("--export", type=str, default=None, help="not ported")
    p.add_argument("--export-platforms", type=str, default=None,
                   help="not ported")
    p.add_argument("--from-export", type=str, default=None, help="not ported")
    p.add_argument("--export-batches", type=str, default=None,
                   help="not ported")
    p.add_argument("--mesh-devices", type=int, default=0, help="not ported")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    for flag, what in _NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag.replace('_', '-')}: {what} is not "
                             f"ported to qiddm_tpu_torch yet")
    if not (args.model and args.ckpt):
        raise SystemExit("need --model and --ckpt")
    device = resolve_device(args.device)
    s = args.img_size
    net = common.build_model(list(args.model), seed=args.seed, device=device)
    load_jax_variables(net, load_checkpoint(args.ckpt)["model_state_dict"])
    diff = Diffusion(net=net, prediction_goal=args.target,
                     shape=(s, s)).eval()

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator().manual_seed(args.seed)
    all_imgs = []
    t_first = t_rest = None
    for b in range(args.batches):
        first_x = (torch.rand((args.n, 1, s, s), generator=gen) * 0.75
                   + 0.5).to(device)
        t0 = time.perf_counter()
        imgs = diff.sample(n_iters=args.iters, first_x=first_x,
                           only_last=True, noise_factor=args.noise_factor)
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
    msg = (f"generated {len(imgs)} images ({args.iters} iters) on {device} "
           f"-> {out_dir}; first batch {t_first:.3f}s (incl one-time set-up)")
    if args.batches > 1:
        steady = (args.batches - 1) * args.n / t_rest
        msg += f", steady {steady:.1f} images/s"
    print(msg)
    return imgs


if __name__ == "__main__":
    main()
