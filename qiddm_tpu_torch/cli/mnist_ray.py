"""The learning-rate and depth sweep (counterpart of
``qiddm_tpu/cli/mnist_ray.py``, reference src/mnist_ray.py).

    python -m qiddm_tpu_torch.cli.mnist_ray --device cuda

The reference runs Ray Tune 2.4 with AsyncHyperBand over
{lr ~ loguniform(1e-4, 1e-1), L ~ randint(6, 16), N = 2, hidden = 6},
50 samples, one trial at a time (src/mnist_ray.py:199-217), each trial
training QIDDM_LL_noise on one MNIST-28 label and reporting its loss and
SSIM. Here the trials are grouped by L, and each group's trials train one
after another on the card through ``qiddm_tpu_torch.sweep`` with
synchronized halving at AsyncHyperBand's rungs. Every flag and default of
the JAX driver, plus ``--device`` (``cuda``, the default, raises without a
card before any data is loaded; ``cpu`` runs the plain PyTorch path).
The artifacts keep the tune_results layout under ``--local-dir``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import nn
from ..config import resolve_device
from ..sweep import asha_rungs, sweep_lr
from . import common


def parse_args(argv):
    p = argparse.ArgumentParser(description="QDDM lr/L sweep (replaces Ray)")
    p.add_argument("--data", type=str, default="mnist_28x28")
    p.add_argument("--img_size", type=int, default=28)
    p.add_argument("--label", type=int, default=4)
    p.add_argument("--n_classes", type=int, default=10)
    p.add_argument("--ds-size", type=int, default=500)
    p.add_argument("--num-samples", type=int, default=50)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--tau", type=int, default=10)
    p.add_argument("--hidden", type=int, default=6)
    p.add_argument("--N", type=int, default=2)
    p.add_argument("--L-min", type=int, default=6)
    p.add_argument("--L-max", type=int, default=16)
    p.add_argument("--lr-min", type=float, default=1e-4)
    p.add_argument("--lr-max", type=float, default=1e-1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--local-dir", type=str, default="tune_results")
    p.add_argument("--exp-name", type=str, default="train_mnist28")
    p.add_argument("--halving", dest="halving", action="store_true",
                   default=True,
                   help="Synchronized successive halving at AsyncHyperBand's "
                        "rung points (grace=1, reduction=4, the reference "
                        "scheduler's defaults, src/mnist_ray.py:207). On by "
                        "default; disable with --no-halving.")
    p.add_argument("--no-halving", dest="halving", action="store_false",
                   help="Train every trial to the full epoch budget.")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cpu", "cuda"],
                   help="'cuda' (the default) raises when no CUDA device "
                        "is present; 'cpu' runs the plain PyTorch path.")
    return p.parse_args(argv)


def main(argv=None):
    """Returns (one row a trial {"L", "lr", "loss", "ssim"}, the row of
    the best SSIM)."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.data not in common.DATA_REGISTRY:
        raise SystemExit(f"unknown dataset {args.data!r}; available: "
                         + ", ".join(sorted(common.DATA_REGISTRY)))
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    lrs = np.exp(rng.uniform(np.log(args.lr_min), np.log(args.lr_max),
                             size=args.num_samples))
    Ls = rng.integers(args.L_min, args.L_max + 1, size=args.num_samples)

    x_all, y_all, h, w = common.load_dataset(args)
    x = x_all[y_all == args.label]
    cutoff = int(len(x) * 0.8)
    x_train, x_test = x[:cutoff], x[cutoff:]
    pixels = h * w

    best = None
    all_rows = []
    for L in sorted(set(int(v) for v in Ls)):
        group = np.nonzero(Ls == L)[0]
        group_lrs = [float(lrs[i]) for i in group]
        print(f"L={L}: {len(group_lrs)} trials (one after another)")
        res = sweep_lr(
            lambda s, L=L: nn.QIDDM_LL_noise(pixels, args.hidden, L, args.N,
                                             0, seed=s, device=device),
            lrs=group_lrs, x_train=x_train, shape=(h, w),
            epochs=args.epochs, batch_size=args.batch_size, T=args.tau,
            local_dir=args.local_dir, exp_name=f"{args.exp_name}_L{L}",
            seed=args.seed, sample_iters=5,
            real_for_ssim=x_test[:20],  # the reference scores on x_test
            rungs=asha_rungs(args.epochs) if args.halving else None,
        )
        for i, lr in enumerate(group_lrs):
            row = {"L": L, "lr": lr, "loss": float(res.final_loss[i]),
                   "ssim": float(res.ssim[i])}
            all_rows.append(row)
            if best is None or row["ssim"] > best["ssim"]:
                best = row

    print("\nBest trial config (ssim, mode=max):", best)
    by_loss = min(all_rows, key=lambda r: r["loss"])
    print("Best trial config (loss, mode=min):", by_loss)
    return all_rows, best


if __name__ == "__main__":
    main()
