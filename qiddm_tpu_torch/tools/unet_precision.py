"""How far float32 carries the U-Nets' sampling step and training gradients,
on the card and on the CPU, against the CPU's float64 result.

Sampling: each of ``--checkpoints`` checkpoints of ``UNetUndirected 3 8 3``
is trained through ``mnist_exm`` on the card at the JAX bench's flags (label
4, batch 8, tau 10, lr 0.01, 5 epochs, a checkpoint each epoch; seeds 42,
43, ...) on a seeded stand-in for MNIST (500 28x28 images, as
``chip_smoke.py`` writes it). From it the card samples 16 start images for 15
iterations (``chip_smoke.py``'s last start batch), and from each iteration's
batch one step is taken by: the card in float32, the CPU in float32, the
card and the CPU in float64, and the card in float32 with TF32 on for cuBLAS
and cuDNN. For each checkpoint the tool reports every step's largest and
root-mean-square distance from the CPU's float64 step over the 15
iterations, and the ratio of the card's float32 distance to the CPU's: the
spread that ``chip_smoke.py``'s FLOOR_FACTOR covers, and the TF32 control
it excludes. At the iteration where the card lies farthest from float64,
each QConv2d and BatchNorm is also run alone in float32 on both devices from
the float64 run's input: where the card's own rounding differs from the
CPU's.

Gradients: for each of ``--seeds`` seeded weights (0, 1, ...) of
``UNetUndirected 3 8 3`` and ``3 8 0``, 3 Adam steps on the card (lr 0.01)
on 8 images of label 4 (``chip_smoke.py``'s batches), and before each the
training loss's gradients on the card and the CPU, in float32 and float64,
with the same noise. Each gradient's distance from the CPU's float64 one is
``chip_smoke.py``'s: the largest over parameters of the max |difference|
relative to the parameter's max norm (to the largest parameter's where the
parameter's is below 1e-6 of it).

Usage: python -m qiddm_tpu_torch.tools.unet_precision [--checkpoints 24]
    [--seeds 12] [--out unet_precision.json]
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import pathlib
import sys
import tempfile

import numpy as np
import torch

from .. import config
from .. import data as data_mod
from ..ckpt import load_checkpoint, load_jax_variables
from ..cli import common as cli_common
from ..cli import mnist_exm
from ..diffusion import Diffusion
from ..nn.layers import FlaxBatchNorm
from ..nn.qconv import QConv2d
from ..noise import add_normal_noise_multiple
from . import common

QUANTUM = ["UNetUndirected", "3", "8", "3"]
CLASSICAL = ["UNetUndirected", "3", "8", "0"]
LABEL, TAU, N, ITERS, START_BATCH = 4, 10, 16, 15, 3
BATCH, LR, GRAD_FLOOR = 8, 0.01, 1e-6


def _dist(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max, root-mean-square) of |got - want|."""
    d = (got.double().cpu() - want.double().cpu()).abs()
    return d.max().item(), d.pow(2).mean().sqrt().item()


@contextlib.contextmanager
def _tf32():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _write_data(data_dir: pathlib.Path) -> np.ndarray:
    """The seeded stand-in for MNIST; returns its images of LABEL."""
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=(500, 28, 28)) ** 3 * 255).astype(np.uint8)
    y = np.arange(500) % 10
    np.savez(data_dir / "mnist_28.npz", x=x, y=y)
    data_mod.DATA_DIR = data_dir
    return x[y == LABEL]


def _train(tmp: pathlib.Path, seed: int) -> dict:
    """The checkpoint's model state after mnist_exm on the card."""
    prefix = f"{tmp}/run{seed}_"
    argv = ["--model", *QUANTUM, "--label", str(LABEL), "--batch_size",
            str(BATCH), "--tau", str(TAU), "--lr", str(LR), "--epochs", "5",
            "--device", "cuda", "--checkpoint-every", "1", "--seed",
            str(seed), "--save-path", prefix, "--load-path", prefix]
    with contextlib.redirect_stdout(io.StringIO()), contextlib.chdir(tmp):
        mnist_exm.main(argv)
    name = cli_common.build_model(QUANTUM, device="cpu").save_name()
    path = pathlib.Path(f"{prefix}{LABEL}/noise_0/{name}_{LABEL}.pt")
    return load_checkpoint(path)["model_state_dict"]


def _local(cpu32, card32, cpu64, x64: torch.Tensor) -> dict:
    """Each QConv2d's and BatchNorm's float32 output on both devices from
    the float64 run's input, against its float64 output."""
    seen, hooks = {}, []
    for name, mod in cpu64.named_modules():
        if isinstance(mod, (QConv2d, FlaxBatchNorm)):
            hooks.append(mod.register_forward_hook(
                lambda m, a, o, name=name: seen.__setitem__(name, (a[0], o))))
    cpu64(x64)
    for h in hooks:
        h.remove()
    cpu_mods, card_mods = dict(cpu32.named_modules()), dict(
        card32.named_modules())
    return {name: {"cpu": _dist(cpu_mods[name](a.float()), o),
                   "card": _dist(card_mods[name](a.float().cuda()), o)}
            for name, (a, o) in seen.items()}


def sampling(state: dict) -> dict:
    """One checkpoint's sampled steps on both devices and dtypes."""
    card = cli_common.build_model(QUANTUM, device="cuda")
    cpu = cli_common.build_model(QUANTUM, device="cpu")
    load_jax_variables(card, state)
    load_jax_variables(cpu, state)
    card.eval()
    cpu.eval()
    card64, cpu64 = copy.deepcopy(card).double(), copy.deepcopy(cpu).double()
    gen = torch.Generator().manual_seed(0)
    for _ in range(START_BATCH):
        first_x = torch.rand((N, 1, 28, 28), generator=gen) * 0.75 + 0.5
    steps = {k: [] for k in ("card32", "cpu32", "card64", "tf32")}
    stack = Diffusion(card, shape=(28, 28)).sample_stack_fn(
        first_x.cuda(), ITERS).cpu()
    for t in range(ITERS):
        x = stack[t]
        exact = cpu64(x.double())
        steps["card32"].append(_dist(card(x.cuda()), exact))
        steps["cpu32"].append(_dist(cpu(x), exact))
        steps["card64"].append(_dist(card64(x.cuda().double()), exact))
        with _tf32():
            steps["tf32"].append(_dist(card(x.cuda()), exact))
    out = {k: [max(v[0] for v in s), max(v[1] for v in s)]
           for k, s in steps.items()}
    worst = max(range(ITERS), key=lambda t: steps["card32"][t][0])
    out["ratio_max"] = out["card32"][0] / out["cpu32"][0]
    out["ratio_rms"] = out["card32"][1] / out["cpu32"][1]
    out["tf32_ratio"] = out["tf32"][0] / out["cpu32"][0]
    out["local"] = _local(cpu, card, cpu64, stack[worst].double())
    return out


def _grads(net, x: torch.Tensor, state: torch.Tensor, device: str,
           dtype: torch.dtype) -> dict:
    """The training loss's gradients of a copy of ``net`` on ``device`` in
    ``dtype``, on the batch ``x`` with the noise image that a CPU generator
    at ``state`` draws (in float32, then cast)."""
    net = copy.deepcopy(net).to(device, dtype)
    net.zero_grad()

    def noise_f(gen, data, tau, decay_mod):
        draw = 0.5 + 0.2 * torch.randn(data.shape, generator=gen)
        return add_normal_noise_multiple(
            gen, data, tau, decay_mod, noise=draw.to(data.device, data.dtype))

    config.enable_x64(dtype == torch.float64)
    try:
        loss, _ = Diffusion(net, noise_f=noise_f).train().loss_fn(
            x.to(device, dtype), TAU,
            generator=torch.Generator().set_state(state))
        loss.backward()
    finally:
        config.enable_x64(False)
    return {n: p.grad.detach().cpu() for n, p in net.named_parameters()}


def _grad_err(got: dict, want: dict) -> float:
    top = max(w.abs().max().item() for w in want.values())
    errs = []
    for n, w in want.items():
        scale = w.abs().max().item()
        errs.append((got[n].double() - w).abs().max().item()
                    / (scale if scale >= GRAD_FLOOR * top else top))
    return max(errs)


def gradients(margs: list, seed: int, images: np.ndarray,
              device: str = "cuda") -> list[dict]:
    """3 Adam steps of ``margs`` from seeded weights on ``device`` (the
    card); before each, its float32 and float64 gradients' and the CPU's
    float32 gradients' distances from the CPU's float64 ones."""
    x = torch.as_tensor(images[:3 * BATCH] / 255.0,
                        dtype=torch.float32).reshape(3, BATCH, -1)
    x = x * (0.7 ** torch.arange(BATCH, dtype=torch.float32))[:, None]
    net = cli_common.build_model(margs, seed=seed, device=device)
    opt = torch.optim.Adam(net.parameters(), lr=LR)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for i in range(3):
        state = gen.get_state()
        exact = _grads(net, x[i], state, "cpu", torch.float64)
        card = _grads(net, x[i], state, device, torch.float32)
        out.append({
            "cpu32": _grad_err(_grads(net, x[i], state, "cpu",
                                      torch.float32), exact),
            "card32": _grad_err(card, exact),
            "card64": _grad_err(_grads(net, x[i], state, device,
                                       torch.float64), exact)})
        for n, p in net.named_parameters():
            p.grad = card[n].to(p.device)
        opt.step()
        torch.randn(x[i].shape, generator=gen)  # the step's noise draw
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoints", type=int, default=24)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--out", default="unet_precision.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("unet_precision: no CUDA device")
    card = common.card(torch.device("cuda", 0))
    runs, grads = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        images = _write_data(tmp)
        for seed in range(42, 42 + args.checkpoints):
            state = _train(tmp, seed)
            with torch.no_grad():
                r = {"seed": seed, **sampling(state)}
            runs.append(r)
            print(f"sampling, checkpoint of seed {seed}: card float32 "
                  f"{r['card32'][0]:.3e} (rms {r['card32'][1]:.3e}), CPU "
                  f"float32 {r['cpu32'][0]:.3e} (rms {r['cpu32'][1]:.3e}) "
                  f"from the CPU's float64 step: ratio {r['ratio_max']:.3f} "
                  f"(rms {r['ratio_rms']:.3f}); card float64 "
                  f"{r['card64'][0]:.3e}; TF32 {r['tf32'][0]:.3e} "
                  f"({r['tf32_ratio']:.1f} x)", flush=True)
    for margs in (CLASSICAL, QUANTUM):
        label = " ".join(margs)
        grads[label] = []
        for seed in range(args.seeds):
            steps = gradients(margs, seed, images)
            grads[label].append(steps)
            print(f"gradients, {label} seed {seed}: card float32 "
                  + ", ".join(f"{s['card32']:.3e}" for s in steps)
                  + "; CPU float32 "
                  + ", ".join(f"{s['cpu32']:.3e}" for s in steps)
                  + "; card float64 "
                  + ", ".join(f"{s['card64']:.3e}" for s in steps),
                  flush=True)
    out = {"card": card, "sampling": runs, "gradients": grads}
    if runs:
        ratios = sorted(r["ratio_max"] for r in runs)
        local = {name: float(np.median([r["local"][name]["card"][1]
                                        / r["local"][name]["cpu"][1]
                                        for r in runs]))
                 for name in runs[0]["local"]}
        out["sampling_summary"] = {
            "ratio_max": [ratios[0], float(np.median(ratios)), ratios[-1]],
            "tf32_ratio_min": min(r["tf32_ratio"] for r in runs),
            "card64_max": max(r["card64"][0] for r in runs),
            "local_rms_ratio_median": local}
        print(f"sampling, {len(runs)} checkpoints ({card}): card/CPU float32 "
              f"distance from float64 min {ratios[0]:.3f}, median "
              f"{np.median(ratios):.3f}, max {ratios[-1]:.3f}; TF32 at least "
              f"{out['sampling_summary']['tf32_ratio_min']:.1f} x the CPU's "
              f"float32; card float64 at most "
              f"{out['sampling_summary']['card64_max']:.3e}; per module, the "
              f"card's rms local error over the CPU's (median): "
              + ", ".join(f"{k} {v:.2f}" for k, v in local.items()))
    for label, per_seed in grads.items():
        steps = [s for seed in per_seed for s in seed]
        if not steps:
            continue
        worst = {k: max(s[k] for s in steps)
                 for k in ("card32", "cpu32", "card64")}
        over = {k: sum(s[k] > 1e-4 for s in steps)
                for k in ("card32", "cpu32")}
        print(f"gradients, {label}, {len(steps)} steps ({card}): largest "
              f"distance from the CPU's float64 step: card float32 "
              f"{worst['card32']:.3e} ({over['card32']} steps above 1e-4), "
              f"CPU float32 {worst['cpu32']:.3e} ({over['cpu32']} above "
              f"1e-4), card float64 {worst['card64']:.3e}")
    pathlib.Path(args.out).write_text(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
