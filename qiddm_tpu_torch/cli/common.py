"""Shared driver logic (counterpart of ``qiddm_tpu/cli/common.py``).

The reference drivers' argparse surface and per-label loop: load, split
80/20, augment (the rebuttal drivers), build, resume, train, save, sample
and score (src/mnist_exm.py:334-503), and the noise drivers' pieces:
``with_noise`` (the test-time swap to a noisy circuit), the sampler-output
caches (``save_outp``/``load_outp``) and the scoring protocols of
``test``. Models and datasets resolve by name through registries instead
of ``eval``. ``--profile LOGDIR`` writes a ``torch.profiler`` trace of each
training run. ``--ckpt-backend orbax`` checkpoints as a
``torch.distributed.checkpoint`` directory (``<save_name>_<label>.dcp``,
``ckpt.save_dcp``), the mid-training saves of ``--checkpoint-every`` in
the background. The PNG dumps and plots need matplotlib: where it cannot
be imported (the card's machine has none), one line says so. The flag for
the vmapped run is rejected before any work, naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import inspect
import pathlib
import pickle
import signal
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import data as data_mod
from .. import metrics
from .. import nn as nn_mod
from ..ckpt import load_diffusion, save_diffusion
from ..config import resolve_device
from ..diffusion import Diffusion
from ..logging_utils import initial_log  # noqa: F401  (re-export for drivers)
from ..noise import add_normal_noise_multiple
from ..profiler import device_trace
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
                   help="Hardware-noise channel type (1-3; 4 = rotation "
                        "angle error).")
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
                   help="Write a torch.profiler trace of each training "
                        "run (CPU and CUDA activity) into LOGDIR.")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="Also checkpoint every N epochs (preemption safety; "
                        "0 = only at the end like the reference).")
    p.add_argument("--ckpt-backend", type=str, default="pt",
                   choices=["pt", "orbax"],
                   help="Checkpoint format: 'pt' (the shared pickle "
                        "layout) or 'orbax' (a torch.distributed.checkpoint "
                        "directory, <save_name>_<label>.dcp; periodic "
                        "saves run in the background).")
    p.add_argument("--noise-backend", type=str, default="dm",
                   choices=["dm", "traj"],
                   help="Channel simulation at noisy test time: 'dm' (the "
                        "exact density matrix) or 'traj' (Monte-Carlo "
                        "trajectories on statevectors).")
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
    or unported models (each is built once on the CPU, so an unported
    option raises here), unknown datasets, and ``--device cuda`` on a host
    without CUDA. ``--add_noise`` and ``--noise_intensity`` pass: the JAX
    drivers read neither (the noise drivers sweep their own settings), and
    every model takes its ``add_noise`` code as a ctor argument."""
    if args.vmap_labels:
        raise SystemExit("--vmap-labels is not ported to qiddm_tpu_torch "
                         "yet (ROADMAP Queue 1 item 11)")
    for m in args.model:
        if m[0] not in MODEL_REGISTRY:
            raise SystemExit(f"model {m[0]!r} is not ported to "
                             f"qiddm_tpu_torch yet (ROADMAP Queue 1); "
                             f"ported: " + ", ".join(sorted(MODEL_REGISTRY)))
        try:  # a ported name with an unported option
            build_model(m, device="cpu")
        except NotImplementedError as err:
            raise SystemExit(f"model {' '.join(map(str, m))} is not ported "
                             f"to qiddm_tpu_torch yet: {err}") from err
    if args.data not in DATA_REGISTRY:
        raise SystemExit(f"unknown dataset {args.data!r}; available: "
                         + ", ".join(sorted(DATA_REGISTRY)))
    resolve_device(args.device)


def model_lr(args, model_name: str) -> float:
    # an explicit --lr from the CLI only: the drivers overwrite ``args.lr``
    # per model, so reading it would leak one model's rate into the next
    if getattr(args, "lr_cli", None):
        return args.lr_cli
    return getattr(args, f"{model_name}_lr", FALLBACK_LR)


def build_model(model_args: Sequence, seed: int = 0, device="cuda",
                init_batch=None):
    """Instantiate a registered model from a ['Name', arg, ...] list on
    ``device``: the card by default, through ``resolve_device``, which
    raises without CUDA; pass ``device="cpu"`` for the plain PyTorch path.
    ``init_batch`` (training images, (b, 1, h, w)) reaches a model whose
    constructor takes it: the lazily fitted PCA (``QIDDM_PP_old``) fits
    on it, as the JAX drivers' models do
    (``qiddm_tpu/cli/common.py:161-180``); the conv and U-Net classes take
    none."""
    name = model_args[0]
    if name not in MODEL_REGISTRY:
        raise SystemExit(f"unknown model {name!r}; ported: "
                         + ", ".join(sorted(MODEL_REGISTRY)))
    params = [int(a) if isinstance(a, str) and a.isdigit() else a
              for a in model_args[1:]]
    ctor = MODEL_REGISTRY[name]
    kwargs = {"seed": seed, "device": resolve_device(device)}
    if "init_batch" in inspect.signature(ctor.__init__).parameters:
        kwargs["init_batch"] = init_batch
    return ctor(*params, **kwargs)


def load_dataset(args):
    x, y, h, w = DATA_REGISTRY[args.data](n_classes=args.n_classes,
                                          ds_size=args.ds_size)
    return np.asarray(x), np.asarray(y), h, w


def augment_rotation(x_train, y_train, height, width, target_size: int,
                     seed: int = 0):
    """Random +-15 degree rotations (scipy's ``ndimage.rotate``, linear,
    zero outside) of randomly picked images, clipped to [0, 1] and
    appended until ``target_size`` images (reference
    src/bloodmnist.py:335-342, :413-460); numpy and scipy only, so the
    same bits as the JAX package's."""
    from scipy.ndimage import rotate

    n = len(x_train)
    if n >= target_size or n == 0:
        return x_train, y_train
    rng = np.random.default_rng(seed)
    extra_x, extra_y = [], []
    for _ in range(target_size - n):
        i = int(rng.integers(0, n))
        img = x_train[i].reshape(height, width)
        ang = float(rng.uniform(-15, 15))
        rot = rotate(img, ang, reshape=False, order=1, mode="constant")
        extra_x.append(np.clip(rot, 0.0, 1.0).reshape(-1))
        extra_y.append(y_train[i])
    return (np.concatenate([x_train, np.stack(extra_x)]),
            np.concatenate([y_train, np.asarray(extra_y)]))


def make_first_x(args, n: int = 10) -> torch.Tensor:
    """The sampler's start images: U[0, 1) * 0.75 + 0.5 from a CPU
    generator seeded with ``seed + 1``."""
    gen = torch.Generator().manual_seed(args.seed + 1)
    return torch.rand((n, 1, args.img_size, args.img_size),
                      generator=gen) * 0.75 + 0.5


def train(diff, args, x_train, start_epoch: int, loss_values: List[float]):
    """Reference train() (src/mnist_exm.py:148-203): Adam over the
    remaining epochs, checkpoint at ``<save_path>/<save_name>_<label>.pt``
    (or ``.dcp`` under ``--ckpt-backend orbax``).

    Training runs in segments of ``--checkpoint-every`` epochs (all at once
    when 0); segment s draws from the seed ``seed + epochs done`` and Adam's
    moments carry over between segments. SIGTERM/SIGINT is deferred to the
    next segment boundary, where the state is checkpointed and the process
    exits 128+signum; rerunning the same command resumes from there. Under
    ``--ckpt-backend orbax`` the mid-training saves run in the background
    (``qiddm_tpu/cli/common.py:283-355``); each is joined before the next
    save and before this returns. With ``--profile LOGDIR`` the run is
    recorded by ``device_trace``.
    """
    print("Training model")
    remaining = args.epochs - start_epoch
    ckpt_every = args.checkpoint_every
    backend = args.ckpt_backend
    pending = None  # the last background save, joined before the next
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

    def _save(epochs_done, async_save=False):
        nonlocal pending
        if pending is not None:
            pending.wait_until_finished()
            pending = None
        out = save_diffusion(diff, args.save_path, args.label, loss_values,
                             epochs_done, backend=backend,
                             async_save=async_save)
        if async_save:
            pending = out

    trace = (device_trace(args.profile) if args.profile
             else contextlib.nullcontext())
    try:
        with trace:
            done = start_epoch
            opt_state = None  # threaded across segments: Adam moments persist
            while remaining > 0:
                seg = min(remaining, ckpt_every) if ckpt_every else remaining
                losses, wall, opt_state = train_diffusion_scan(
                    diff, x_train, epochs=seg, batch_size=args.batch_size,
                    lr=args.lr, T=args.tau, warmup=False,
                    key=args.seed + done, opt_state=opt_state,
                    return_opt_state=True)
                loss_values = list(loss_values) + [float(v) for v in losses]
                done += seg
                remaining -= seg
                print(f"trained {seg} epochs in {wall:.3f}s incl. set-up "
                      f"({len(x_train) * seg / max(wall, 1e-9):.0f} "
                      f"images/s)")
                if caught["sig"] is not None:
                    _save(done)
                    print(f"[preempt] checkpoint saved at epoch {done}/"
                          f"{args.epochs}; rerun the same command to resume",
                          file=sys.stderr)
                    raise SystemExit(128 + caught["sig"])
                if ckpt_every and remaining > 0:
                    _save(done, async_save=(backend == "orbax"))
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
    _save(args.epochs)
    return loss_values


def with_noise(net, add_noise: int, noise_intensity=None,
               noise_trajectories: int = 0):
    """A shim that shares ``net``'s trained parameters but runs its circuit
    with hardware noise: the test-time swap to a noisy simulation
    (``qiddm_tpu/cli/common.py:214-254``; reference
    src/mnist_noise.py:210-230). Non-unitary channels take the
    density-matrix backend, or with ``noise_trajectories > 0`` the
    Monte-Carlo trajectory backend; sampling then needs
    ``Diffusion.sample(..., traj_rng=<generator on the net's device>)``.

    The module is a shallow copy: the same parameter tensors, its own
    ``add_noise`` and ``noise_intensity``. An explicit intensity becomes a
    0-d float32 tensor on the module's device (the JAX package's
    ``noise_cfg`` variable); :func:`set_noise_intensity` changes it in place
    for the next value of a sweep. A net whose module takes no noise comes
    back as it is."""
    module = net.module
    if not hasattr(module, "add_noise"):
        return net
    noisy = copy.copy(module)  # shares _parameters and _modules
    noisy.add_noise = add_noise
    if noise_trajectories:
        noisy.noise_trajectories = noise_trajectories
    noisy.noise_intensity = None
    if noise_intensity is not None and add_noise != 0:
        noisy.noise_intensity = torch.tensor(
            float(noise_intensity), dtype=torch.float32,
            device=next(module.parameters()).device)
    clone = copy.copy(net)
    clone._modules = dict(net._modules, module=noisy)
    return clone


def set_noise_intensity(net, value: float) -> None:
    """Set the intensity of a :func:`with_noise` net in place: a fill of
    its device tensor, no new program and no host sync."""
    net.module.noise_intensity.fill_(float(value))


@dataclasses.dataclass(frozen=True)
class ScoreProtocol:
    """How ``test()`` post-processes the sampled images before scoring,
    and what the drivers score, per driver
    (``qiddm_tpu/cli/common.py:358-389``):

    * mnist_exm (src/mnist_exm.py:206-261, 471-480): generated min-max
      renormalized to [0, 1] per step, real (x_test) min-max to [0, 1],
      (gen 5, real 80), PSNR and cosine beside SSIM;
    * fashion_exm / emnist_exm (src/fashion_exm.py:216-260, 459-468 /
      src/emnist_exm.py:206-250, 441-450): generated kept in [0, 255], real
      (x_test) min-max then x255 and clamped, (1, 10) / (1, 20);
    * the rebuttal drivers (src/bloodmnist.py:206-288, 523-524): generated
      in [0, 255], real from the augmented **x_train** min-max x255, SSIM
      only, (10, 20);
    * the noise drivers (src/mnist_noise.py:240-262, 513-526): as fashion,
      (1, 2).
    """
    renorm_generated: bool = True
    real_255: bool = False
    real_from_train: bool = False
    gen_count: int = 5
    real_count: int = 80
    psnr_cos: bool = True


MNIST_PROTOCOL = ScoreProtocol()
FASHION_PROTOCOL = ScoreProtocol(False, True, False, 1, 10, True)
EMNIST_PROTOCOL = ScoreProtocol(False, True, False, 1, 20, True)
REBUTTAL_PROTOCOL = ScoreProtocol(False, True, True, 10, 20, False)
NOISE_PROTOCOL = ScoreProtocol(False, True, False, 1, 2, True)


def test(diff, args, x_train, x_test, first_x, tau_test: int = 15,
         save_images: bool = True, grid=None,
         protocol: ScoreProtocol = MNIST_PROTOCOL):
    """Reference test() (src/mnist_exm.py:206-291): sample ``tau_test``
    iterations (or take the sampler's ``grid``, (iters*h, b*w), from a
    cache), clamp and scale to [0, 255], renormalize as ``protocol`` says;
    the real images are ``x_test``, or ``x_train`` under the protocol's
    ``real_from_train``. Returns (generated (iters+1, b, 1, h, w), real) as
    numpy. With ``save_images`` and a save path it dumps the PNGs
    (:func:`_dump_images`), or says in one line that matplotlib is
    missing."""
    print("Testing model")
    s = args.img_size
    if grid is None:
        t0 = time.perf_counter()
        grid = diff.eval().sample(first_x=first_x.to(diff.net.device),
                                  n_iters=tau_test, only_last=False).cpu()
        wall = time.perf_counter() - t0
        print(f"sampled {len(first_x)} images x {tau_test} iterations on "
              f"{diff.net.device} in {wall:.3f} s "
              f"({len(first_x) / max(wall, 1e-9):.2f} images/s)")
    grid = torch.as_tensor(np.asarray(grid.cpu() if torch.is_tensor(grid)
                                      else grid))
    outp = torch.clamp(torch.clamp(grid, 0.0, 1.0) * 255.0, 0.0, 255.0)
    outp = outp.numpy()
    # "(iters height) (batch width) -> iters batch 1 height width"
    gen = outp.reshape(tau_test + 1, s, -1, s).transpose(0, 2, 1, 3)[
        :, :, None].copy()
    if protocol.renorm_generated:
        for step in range(gen.shape[0]):
            g = gen[step]
            gmin = g.reshape(len(g), -1).min(1)[:, None, None, None]
            gmax = g.reshape(len(g), -1).max(1)[:, None, None, None]
            gen[step] = (g - gmin) / (gmax - gmin + 1e-7)
    real_src = x_train if protocol.real_from_train else x_test
    real = np.asarray(real_src).reshape(-1, 1, s, s)
    rmin = real.reshape(len(real), -1).min(1)[:, None, None, None]
    rmax = real.reshape(len(real), -1).max(1)[:, None, None, None]
    real = (real - rmin) / (rmax - rmin + 1e-7)
    if protocol.real_255:
        real = np.clip(real * 255.0, 0.0, 255.0)
    if save_images and args.save_path:
        if metrics.plots_available():
            _dump_images(args, x_train, gen, outp, diff)
        else:
            print(metrics.NO_PLOTS.format(what="the PNG dumps"))
    return gen, real


def _dump_images(args, x_train, generated, grid, diff):
    """The reference's PNG dumps (``qiddm_tpu/cli/common.py:434-450``): up
    to 100 training images under ``image_0/``, every sampled image's steps
    under ``image_<i>/`` and the sampler's grid as
    ``<save_name>_<label>.png``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    s = args.img_size
    base = pathlib.Path(args.save_path)
    img0 = base / "image_0"
    img0.mkdir(parents=True, exist_ok=True)
    for i in range(min(len(x_train), 100)):
        plt.imsave(img0 / f"train_image_{i + 1}.png",
                   np.asarray(x_train[i]).reshape(s, s), cmap="gray")
    for i in range(generated.shape[1]):
        folder = base / f"image_{i + 1}"
        folder.mkdir(parents=True, exist_ok=True)
        for j in range(generated.shape[0]):
            plt.imsave(folder / f"step_{j + 1}.png", generated[j, i, 0],
                       cmap="gray")
    plt.imshow(grid, cmap="gray")
    plt.axis("off")
    plt.savefig(base / f"{diff.save_name()}_{args.label}.png")
    plt.close()


def _outp_path(diff, path, noise_intensity, backend: str) -> pathlib.Path:
    """The sampler-output cache of one intensity: the JAX package's name,
    so each package reads the other's. The trajectory backend's carry a
    ``_traj`` tag: its grids are statistical estimates, and a dm run never
    serves a traj run's cache or the other way round."""
    tag = "_traj" if backend == "traj" else ""
    return (pathlib.Path(path)
            / f"{diff.save_name()}_outp_{noise_intensity}{tag}.pt")


def save_outp(diff, args, outp, noise_intensity) -> pathlib.Path:
    """Pickle the sampler's grid as a numpy array, as
    ``qiddm_tpu/cli/common.py:458-467`` does, tagged by
    ``args.noise_backend``."""
    sp = _outp_path(diff, args.save_path, noise_intensity,
                    getattr(args, "noise_backend", "dm"))
    sp.parent.mkdir(parents=True, exist_ok=True)
    grid = outp.detach().cpu().numpy() if torch.is_tensor(outp) else outp
    with open(sp, "wb") as f:
        pickle.dump(np.asarray(grid), f)
    return sp


def load_outp(diff, load_path, noise_intensity, backend: str = "dm"):
    """A cached sampler grid of ``backend`` ("dm" or "traj"), or None
    (reference src/mnist_noise.py:285-308). Unpickling runs code: load only
    caches this project wrote."""
    lp = _outp_path(diff, load_path, noise_intensity, backend)
    print(lp)
    try:
        with open(lp, "rb") as f:
            out = pickle.load(f)
        print("outp loaded successfully.\n")
        return out
    except FileNotFoundError:
        print("Failed to load outp: File not found.\n")
        return None


def run_labels(args, labels, *, augment_to: Optional[int] = None,
               tau_test: int = 15,
               protocol: ScoreProtocol = MNIST_PROTOCOL):
    """The reference drivers' main loop (src/mnist_exm.py:334-503): per
    label, load, split 80/20, augment the training split to ``augment_to``
    images by rotation (the rebuttal drivers), and per model build,
    resume, train, save, sample and score as ``protocol`` says. Returns
    ``{model key: {"loss", "generated", "real", "ssim", "psnr", "cos"}}``,
    one entry per label in each list: the epoch losses, the sampled and
    real images (``test``), and the last iteration's scores over the
    protocol's (gen, real) pair counts, NaN for PSNR and cosine under a
    protocol without them (the rebuttal drivers score SSIM only). A label
    with no images raises ``ValueError``, as in the JAX package. Where
    matplotlib can be imported, each label's loss and score curves are
    plotted and, over several labels, the histograms
    (:func:`_plot_label`, :func:`_plot_histograms`); elsewhere one line
    says they are skipped."""
    validate_args(args)
    device = resolve_device(args.device)
    original_save, original_load = args.save_path, args.load_path
    names = [m[0] for m in args.model]

    def model_key(i, margs):
        # --model may list one name twice with different parameters
        return margs[0] if names.count(margs[0]) == 1 else f"{margs[0]}#{i}"

    results: Dict[str, Dict[str, list]] = {
        model_key(i, m): {k: [] for k in ("loss", "generated", "real",
                                          "ssim", "psnr", "cos")}
        for i, m in enumerate(args.model)}
    gc, rc = protocol.gen_count, protocol.real_count
    for label in labels:
        args.label = label
        print(args)
        # the reference trains clean, under noise_0
        args.save_path = original_save + str(label) + "/noise_0"
        args.load_path = original_load + str(label) + "/noise_0"

        x_all, y_all, height, width = load_dataset(args)
        x_lab, y_lab = x_all[y_all == label], y_all[y_all == label]
        if len(x_lab) == 0:
            raise ValueError(
                f"label {label} has no images in dataset {args.data!r} "
                f"(available labels: {sorted(set(int(v) for v in y_all))})")
        x_lab = x_lab[: int(len(x_lab) * args.reduced_size)]
        y_lab = y_lab[: len(x_lab)]
        print(f"description of dataset: len of x_train: {x_lab.shape}\n")
        cutoff = int(len(x_lab) * 0.8)
        x_train, x_test = x_lab[:cutoff], x_lab[cutoff:]
        y_train = y_lab[:cutoff]
        if augment_to:
            x_train, y_train = augment_rotation(
                x_train, y_train, height, width, augment_to, args.seed)
            print(f"After augmentation, x_train shape: {x_train.shape}")
        first_x = make_first_x(args)
        if args.batch_size > len(x_train):
            print(f"Warning: batch size ({args.batch_size}) is bigger than "
                  f"the data size ({len(x_train)}). Setting batch size to "
                  f"data size.")
            args.batch_size = max(len(x_train), 1)

        init_batch = x_train[:32].reshape(-1, 1, height, width)
        curves = {"loss": {}, "generated": {}, "real": {}}
        for mi, model_args in enumerate(args.model):
            model_name = model_args[0]
            net = build_model(model_args, seed=args.seed, device=device,
                              init_batch=init_batch)
            args.lr = model_lr(args, model_name)
            print(f"Initialized {model_name} with parameters "
                  f"{model_args[1:]}, with {args.lr}")
            diff = Diffusion(net, add_normal_noise_multiple, args.target,
                             (height, width))
            print("parameters:%d\n" % net.num_params())
            loss_values, start_epoch = load_diffusion(
                diff, args.load_path, label,
                backend="auto" if args.ckpt_backend == "pt" else "orbax")
            print(f"epoch start from {start_epoch}, "
                  f"left {args.epochs - start_epoch}")
            loss_values = train(diff, args, x_train, start_epoch,
                                loss_values)
            generated, real = test(diff, args, x_train, x_test, first_x,
                                   tau_test=tau_test, protocol=protocol)
            # the results keep each score's last iteration only
            last = generated[-1:]
            nan = float("nan")
            scores = {"ssim": float(metrics.ssim_iterations(
                last, real, gc, rc)[-1])}
            scores["psnr"] = (float(metrics.psnr_iterations(
                last, real, gc, rc)[-1]) if protocol.psnr_cos else nan)
            scores["cos"] = (float(metrics.cosine_iterations(
                last, real, gc, rc)[-1]) if protocol.psnr_cos else nan)
            print(f"label {label} {diff.save_name()}: last iteration's SSIM "
                  f"{scores['ssim']:.6f}, PSNR {scores['psnr']:.6f}, cosine "
                  f"{scores['cos']:.6f} (gen {gc}, real {rc})")
            entry = results[model_key(mi, model_args)]
            curves["loss"][model_key(mi, model_args)] = loss_values
            curves["generated"][f"{diff.save_name()}#{mi}"] = generated
            curves["real"][f"{diff.save_name()}#{mi}"] = real
            entry["loss"].append(loss_values)
            entry["generated"].append(generated)
            entry["real"].append(real)
            for k, v in scores.items():
                entry[k].append(v)
        if metrics.plots_available():
            _plot_label(args, curves, protocol)
    args.save_path, args.load_path = original_save, original_load
    if not metrics.plots_available():
        print(metrics.NO_PLOTS.format(
            what="the loss/SSIM/PSNR/cosine plots and histograms"))
    elif len(list(labels)) > 1 and args.save_path:
        _plot_histograms(args, results, protocol)
    return results


def _plot_label(args, curves, protocol: ScoreProtocol) -> None:
    """One label's plots (``qiddm_tpu/cli/common.py:734-752``): the loss
    curves and the score of every sampling iteration, SSIM and, under a
    protocol with them, PSNR and cosine, over the protocol's pair counts.
    The last model's name and parameters name the loss plot."""
    margs = args.model[-1]
    metrics.show_metrics(curves["loss"], "LOSS", args, model_name=margs[0],
                         model_params=margs[1:], is_loss=True)
    gc, rc = protocol.gen_count, protocol.real_count
    scorers = [metrics.get_ssim]
    if protocol.psnr_cos:
        scorers += [metrics.get_psnr, metrics.get_cosine_similarity]
    for scorer in scorers:
        scorer(curves["generated"], curves["real"], args, gen_img_count=gc,
               real_img_count=rc)


def _plot_histograms(args, results, protocol: ScoreProtocol) -> None:
    """The cross-label comparison histograms of the last iteration's
    scores (reference src/mnist_exm.py:498-502): of the scores the
    protocol takes. (The JAX package also draws PSNR's and cosine's for
    the rebuttal drivers, whose NaN scores matplotlib refuses as axis
    limits.)"""
    for metric_name in ("ssim", "psnr", "cos")[:3 if protocol.psnr_cos
                                               else 1]:
        metrics.show_histogram(
            {m: results[m][metric_name] for m in results},
            metric_name.upper(), args)
