"""Shared driver logic (counterpart of ``qiddm_tpu/cli/common.py``).

The reference drivers' argparse surface and per-label loop: load, split
80/20, build, resume, train, save, sample (src/mnist_exm.py:334-503).
Models and datasets resolve by name through registries instead of
``eval``. Scoring (``metrics.*``), PNG dumps and plots are ROADMAP Queue 1
item 10; the flags for the vmapped, profiled, orbax, trajectory and
hardware-noise runs are rejected before any work, naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import signal
import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import data as data_mod
from .. import nn as nn_mod
from ..ckpt import load_diffusion, save_diffusion
from ..config import resolve_device
from ..diffusion import Diffusion
from ..logging_utils import initial_log  # noqa: F401  (re-export for drivers)
from ..noise import add_normal_noise_multiple
from ..train import train_diffusion_scan

MODEL_REGISTRY = {
    name: obj
    for name in dir(nn_mod)
    if isinstance(obj := getattr(nn_mod, name), type)
    and issubclass(obj, nn_mod.DenoiserShim)
    and obj is not nn_mod.DenoiserShim
}

DATA_REGISTRY = dict(data_mod.ALL_LOADERS)

# per-model default learning rates (reference src/mnist_exm.py:130-141)
DEFAULT_LRS = {
    "UNetUndirected": 0.01,
    "differN_noise": 0.00914,
    "QDenseUndirected_old_noise": 0.00211,
    "QIDDM_LL_noise": 0.0255,
    "QIDDM_PL_noise": 0.01116,
    "QNN_noise": 0.01011,
}
FALLBACK_LR = 0.01

_NOT_PORTED = "ROADMAP Queue 1 item 10"


def build_parser(description: str, *, default_models, default_data: str,
                 default_img_size: int, default_label: int = 0,
                 default_ds_size: int = 500, default_epochs: int = 50,
                 default_batch_size: int = 1, default_tau: int = 10,
                 with_noise_intensity: bool = False,
                 default_save_path: str = "results/run/",
                 default_load_path: str = "results/run/"):
    """Every flag of the JAX package's parser; :func:`validate_args`
    rejects the ones this port does not serve yet."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--model", type=str, default=None, nargs="+",
                   action="append",
                   help="Model name and parameters (repeatable); ported: "
                        + ", ".join(sorted(MODEL_REGISTRY)))
    p.add_argument("--data", type=str, default=default_data,
                   help="Dataset: " + ", ".join(sorted(DATA_REGISTRY)))
    p.add_argument("--img_size", type=int, default=default_img_size)
    p.add_argument("--label", type=int, default=default_label,
                   help="Label used for training.")
    p.add_argument("--add_noise", type=int, default=0,
                   help="Hardware-noise channel type (not ported: only 0).")
    if with_noise_intensity:
        p.add_argument("--noise_intensity", type=float, default=0.02,
                       help="Channel strength for the noise sweep (0-1).")
    p.add_argument("--reduced_size", type=float, default=1.0)
    p.add_argument("--load-path", type=str, default=default_load_path)
    p.add_argument("--save-path", type=str, default=default_save_path)
    p.add_argument("--n_classes", type=int, default=10)
    p.add_argument("--target", type=str, default="data",
                   help="Generate noise or data.")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cpu", "cuda"],
                   help="'cuda' (the default) raises when no CUDA device "
                        "is present; 'cpu' runs the plain PyTorch path.")
    p.add_argument("--tau", type=int, default=default_tau)
    p.add_argument("--ds-size", type=int, default=default_ds_size,
                   help="Dataset size. 80%% is used for training.")
    for name, lr in DEFAULT_LRS.items():
        p.add_argument(f"--{name}_lr", type=float, default=lr)
    p.add_argument("--lr", type=float, default=None,
                   help="Override learning rate for all models.")
    p.add_argument("--epochs", type=int, default=default_epochs)
    p.add_argument("--batch_size", type=int, default=default_batch_size)
    p.add_argument("--vmap-labels", action="store_true",
                   help="Train all labels at once (not ported).")
    p.add_argument("--profile", type=str, default=None, metavar="LOGDIR",
                   help="Capture a device trace (not ported).")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="Also checkpoint every N epochs (preemption safety; "
                        "0 = only at the end like the reference).")
    p.add_argument("--ckpt-backend", type=str, default="pt",
                   choices=["pt", "orbax"],
                   help="Checkpoint format: 'pt' (the shared pickle "
                        "layout); 'orbax' is not ported.")
    p.add_argument("--noise-backend", type=str, default="dm",
                   choices=["dm", "traj"],
                   help="Channel simulation at noisy test time ('traj' is "
                        "not ported).")
    p.add_argument("--n-traj", type=int, default=100,
                   help="Trajectory count for --noise-backend traj.")

    orig_parse = p.parse_args

    def parse_args(argv=None, namespace=None):
        args = orig_parse(argv, namespace)
        args.model = ([list(m) for m in args.model] if args.model
                      else [list(m) for m in default_models])
        args.lr_cli = args.lr  # explicit --lr override, before per-model writes
        return args

    p.parse_args = parse_args
    return p


def validate_args(args) -> None:
    """Fail fast, before any data or device work: unported flags, unknown
    or unported models and datasets, and ``--device cuda`` on a host
    without CUDA."""
    unported = {
        "--vmap-labels": (args.vmap_labels, "ROADMAP Queue 1 item 11"),
        "--profile": (args.profile, "ROADMAP Queue 1 item 10"),
        "--ckpt-backend orbax": (args.ckpt_backend == "orbax",
                                 "ROADMAP Queue 1 item 10"),
        "--noise-backend traj": (args.noise_backend == "traj",
                                 "ROADMAP Queue 1 item 8"),
        f"--add_noise {args.add_noise}": (args.add_noise != 0,
                                          "ROADMAP Queue 1 item 8"),
    }
    for flag, (given, item) in unported.items():
        if given:
            raise SystemExit(f"{flag} is not ported to qiddm_tpu_torch "
                             f"yet ({item})")
    for m in args.model:
        if m[0] not in MODEL_REGISTRY:
            raise SystemExit(f"model {m[0]!r} is not ported to "
                             f"qiddm_tpu_torch yet (ROADMAP Queue 1); "
                             f"ported: " + ", ".join(sorted(MODEL_REGISTRY)))
    if args.data not in DATA_REGISTRY:
        raise SystemExit(f"dataset {args.data!r} is not ported to "
                         f"qiddm_tpu_torch yet ({_NOT_PORTED}); ported: "
                         + ", ".join(sorted(DATA_REGISTRY)))
    resolve_device(args.device)


def model_lr(args, model_name: str) -> float:
    # an explicit --lr from the CLI only: the drivers overwrite ``args.lr``
    # per model, so reading it would leak one model's rate into the next
    if getattr(args, "lr_cli", None):
        return args.lr_cli
    return getattr(args, f"{model_name}_lr", FALLBACK_LR)


def build_model(model_args: Sequence, seed: int = 0, device="cpu"):
    """Instantiate a registered model from a ['Name', arg, ...] list on
    ``device``."""
    name = model_args[0]
    if name not in MODEL_REGISTRY:
        raise SystemExit(f"unknown model {name!r}; ported: "
                         + ", ".join(sorted(MODEL_REGISTRY)))
    params = [int(a) if isinstance(a, str) and a.isdigit() else a
              for a in model_args[1:]]
    return MODEL_REGISTRY[name](*params, seed=seed, device=device)


def load_dataset(args):
    x, y, h, w = DATA_REGISTRY[args.data](n_classes=args.n_classes,
                                          ds_size=args.ds_size)
    return np.asarray(x), np.asarray(y), h, w


def make_first_x(args, n: int = 10) -> torch.Tensor:
    """The sampler's start images: U[0, 1) * 0.75 + 0.5 from a CPU
    generator seeded with ``seed + 1``."""
    gen = torch.Generator().manual_seed(args.seed + 1)
    return torch.rand((n, 1, args.img_size, args.img_size),
                      generator=gen) * 0.75 + 0.5


def train(diff, args, x_train, start_epoch: int, loss_values: List[float]):
    """Reference train() (src/mnist_exm.py:148-203): Adam over the
    remaining epochs, checkpoint at ``<save_path>/<save_name>_<label>.pt``.

    Training runs in segments of ``--checkpoint-every`` epochs (all at once
    when 0); segment s draws from the seed ``seed + epochs done`` and Adam's
    moments carry over between segments. SIGTERM/SIGINT is deferred to the
    next segment boundary, where the state is checkpointed and the process
    exits 128+signum; rerunning the same command resumes from there.
    """
    print("Training model")
    remaining = args.epochs - start_epoch
    ckpt_every = args.checkpoint_every
    caught = {"sig": None}

    def _defer_to_boundary(signum, frame):
        caught["sig"] = signum
        print(f"[preempt] caught signal {signum}; checkpointing at the "
              f"next segment boundary", file=sys.stderr)

    prev_handlers = {}
    for s in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[s] = signal.signal(s, _defer_to_boundary)
        except ValueError:  # not the main thread (e.g. under a test runner)
            pass

    def _save(epochs_done):
        save_diffusion(diff, args.save_path, args.label, loss_values,
                       epochs_done)

    try:
        done = start_epoch
        opt_state = None  # threaded across segments: Adam moments persist
        while remaining > 0:
            seg = min(remaining, ckpt_every) if ckpt_every else remaining
            losses, wall, opt_state = train_diffusion_scan(
                diff, x_train, epochs=seg, batch_size=args.batch_size,
                lr=args.lr, T=args.tau, warmup=False, key=args.seed + done,
                opt_state=opt_state, return_opt_state=True)
            loss_values = list(loss_values) + [float(v) for v in losses]
            done += seg
            remaining -= seg
            print(f"trained {seg} epochs in {wall:.3f}s incl. set-up "
                  f"({len(x_train) * seg / max(wall, 1e-9):.0f} images/s)")
            if caught["sig"] is not None:
                _save(done)
                print(f"[preempt] checkpoint saved at epoch {done}/"
                      f"{args.epochs}; rerun the same command to resume",
                      file=sys.stderr)
                raise SystemExit(128 + caught["sig"])
            if ckpt_every and remaining > 0:
                _save(done)
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
    _save(args.epochs)
    return loss_values


def test(diff, args, x_test, first_x, tau_test: int = 15,
         save_images: bool = True):
    """Reference test() (src/mnist_exm.py:206-291) under the MNIST
    protocol: sample ``tau_test`` iterations, clamp and scale to [0, 255],
    min-max each step's images to [0, 1], min-max the real images; returns
    (generated (iters+1, b, 1, h, w), real). PNG dumps are not ported."""
    print("Testing model")
    s = args.img_size
    grid = diff.eval().sample(first_x=first_x.to(diff.net.device),
                              n_iters=tau_test, only_last=False)
    outp = torch.clamp(torch.clamp(grid, 0.0, 1.0) * 255.0, 0.0, 255.0)
    outp = outp.cpu().numpy()
    # "(iters height) (batch width) -> iters batch 1 height width"
    gen = outp.reshape(tau_test + 1, s, -1, s).transpose(0, 2, 1, 3)[
        :, :, None].copy()
    for step in range(gen.shape[0]):
        g = gen[step]
        gmin = g.reshape(len(g), -1).min(1)[:, None, None, None]
        gmax = g.reshape(len(g), -1).max(1)[:, None, None, None]
        gen[step] = (g - gmin) / (gmax - gmin + 1e-7)
    real = np.asarray(x_test).reshape(-1, 1, s, s)
    rmin = real.reshape(len(real), -1).min(1)[:, None, None, None]
    rmax = real.reshape(len(real), -1).max(1)[:, None, None, None]
    real = (real - rmin) / (rmax - rmin + 1e-7)
    if save_images and args.save_path:
        print(f"PNG dumps are not ported ({_NOT_PORTED})")
    return gen, real


def run_labels(args, labels, *, tau_test: int = 15):
    """The reference drivers' main loop (src/mnist_exm.py:334-503): per
    label, load, split 80/20, and per model build, resume, train, save and
    sample. Returns ``{model key: {"loss": [...], "generated": [...],
    "real": [...]}}``, one entry per label in each list. Scores and plots
    are not ported: one line says so."""
    validate_args(args)
    device = resolve_device(args.device)
    original_save, original_load = args.save_path, args.load_path
    names = [m[0] for m in args.model]

    def model_key(i, margs):
        # --model may list one name twice with different parameters
        return margs[0] if names.count(margs[0]) == 1 else f"{margs[0]}#{i}"

    results: Dict[str, Dict[str, list]] = {
        model_key(i, m): {"loss": [], "generated": [], "real": []}
        for i, m in enumerate(args.model)}
    for label in labels:
        args.label = label
        print(args)
        # one hardware-noise setting (add_noise 0) is ported
        args.save_path = original_save + str(label) + "/noise_0"
        args.load_path = original_load + str(label) + "/noise_0"

        x_all, y_all, height, width = load_dataset(args)
        x_lab, y_lab = x_all[y_all == label], y_all[y_all == label]
        if len(x_lab) == 0:
            raise ValueError(
                f"label {label} has no images in dataset {args.data!r} "
                f"(available labels: {sorted(set(int(v) for v in y_all))})")
        x_lab = x_lab[: int(len(x_lab) * args.reduced_size)]
        print(f"description of dataset: len of x_train: {x_lab.shape}\n")
        cutoff = int(len(x_lab) * 0.8)
        x_train, x_test = x_lab[:cutoff], x_lab[cutoff:]
        first_x = make_first_x(args)
        if args.batch_size > len(x_train):
            print(f"Warning: batch size ({args.batch_size}) is bigger than "
                  f"the data size ({len(x_train)}). Setting batch size to "
                  f"data size.")
            args.batch_size = max(len(x_train), 1)

        for mi, model_args in enumerate(args.model):
            model_name = model_args[0]
            net = build_model(model_args, seed=args.seed, device=device)
            args.lr = model_lr(args, model_name)
            print(f"Initialized {model_name} with parameters "
                  f"{model_args[1:]}, with {args.lr}")
            diff = Diffusion(net, add_normal_noise_multiple, args.target,
                             (height, width))
            print("parameters:%d\n" % net.num_params())
            loss_values, start_epoch = load_diffusion(diff, args.load_path,
                                                      label)
            print(f"epoch start from {start_epoch}, "
                  f"left {args.epochs - start_epoch}")
            loss_values = train(diff, args, x_train, start_epoch,
                                loss_values)
            generated, real = test(diff, args, x_test, first_x,
                                   tau_test=tau_test)
            entry = results[model_key(mi, model_args)]
            entry["loss"].append(loss_values)
            entry["generated"].append(generated)
            entry["real"].append(real)
    args.save_path, args.load_path = original_save, original_load
    print(f"SSIM/PSNR/cosine scores and plots are not ported "
          f"({_NOT_PORTED})")
    return results
