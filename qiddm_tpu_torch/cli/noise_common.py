"""Shared logic of the hardware-noise robustness drivers (counterpart of
``qiddm_tpu/cli/noise_common.py``).

Reference: src/mnist_noise.py / src/fashion_noise.py — train each model
clean (add_noise=0), then at test time inject each channel type at a sweep
of intensities by swapping the circuit to a density-matrix simulation
(src/mnist_noise.py:210-230, :432-444), caching the sampler's output per
intensity (:285-308) and scoring it (:513-526).

Here the swap is ``common.with_noise``: the same trained parameters, a
noisy circuit. One noisy net serves a channel type's whole intensity list:
its intensity is a device tensor set in place per value, so no program is
rebuilt and nothing is read back to the host between values. With
``--noise-backend traj`` the noisy net estimates the channels with
``--n-traj`` Monte-Carlo trajectories, drawing from a generator on the
net's device seeded ``seed + 17`` afresh for every intensity (the JAX
package passes one key to every intensity's sampler), and the caches carry
the ``_traj`` tag. The metric-vs-intensity curves of each channel type are
plotted where matplotlib can be imported; elsewhere one line says they are
skipped.
"""

from __future__ import annotations

import time

import torch

from .. import metrics
from ..ckpt import load_diffusion
from ..config import resolve_device
from ..diffusion import Diffusion
from ..noise import add_normal_noise_multiple
from . import common

NOISE_TYPE_LABELS = {
    1: "Phase Damping intensity",
    2: "Amplitude Damping intensity",
    3: "Depolarizing intensity",
    4: "Rotation Angle error intensity",
}


def run_noise_sweep(args, *, noise_types, intensities, tau_test=None,
                    gen_img_count=1, real_img_count=2):
    """Train clean once per model, then sweep (noise type x intensity) at
    test time; returns {model: {type: {metric: [per-intensity]}}} with the
    metrics "ssim", "psnr", "cos" and "fid".

    The pair counts default to the mnist_noise reference scoring
    (gen_img_count=1, real_img_count=2, src/mnist_noise.py:513-526);
    fashion_noise passes (1, 90). ``args`` comes back as it was given."""
    if tau_test is None:
        tau_test = args.tau * 2
    common.validate_args(args)
    original = dict(save_path=args.save_path, load_path=args.load_path,
                    batch_size=args.batch_size, lr=args.lr)
    try:
        return _run_noise_sweep(args, noise_types=noise_types,
                                intensities=intensities, tau_test=tau_test,
                                gen_img_count=gen_img_count,
                                real_img_count=real_img_count)
    finally:
        for k, v in original.items():
            setattr(args, k, v)


def traj_generator(args, device) -> torch.Generator:
    """The trajectory backend's random source for one intensity's
    sampling: seeded ``seed + 17`` on the net's device
    (``qiddm_tpu/cli/noise_common.py:166-168``)."""
    return torch.Generator(device=device).manual_seed(args.seed + 17)


def _sample_grids(diff, args, first_x, tau_test: int, intensities) -> dict:
    """The sampler grid of every intensity, from the caches of
    ``args.noise_backend`` under ``args.load_path`` where they exist, else
    sampled on the net's device and cached under ``args.save_path``. Prints
    the sampling wall of the values it sampled."""
    backend = getattr(args, "noise_backend", "dm")
    device = diff.net.device

    def sample(first_x):
        rng = traj_generator(args, device) if backend == "traj" else None
        return diff.eval().sample(first_x=first_x, n_iters=tau_test,
                                  only_last=False,
                                  traj_rng=rng).cpu().numpy()

    grids, missing = {}, []
    for intensity in intensities:
        cached = common.load_outp(diff, args.load_path, intensity, backend)
        if cached is not None:
            grids[intensity] = cached
        else:
            missing.append(intensity)
    if not missing:
        return grids
    first_x = first_x.to(device)
    t0 = time.perf_counter()
    if getattr(diff.net.module, "noise_intensity", None) is not None:
        for intensity in missing:
            common.set_noise_intensity(diff.net, intensity)
            grids[intensity] = sample(first_x)
    else:
        # no intensity to set (a clean code or a net without noise): the
        # sampler's output cannot depend on it, so sample once
        one = sample(first_x)
        grids.update({intensity: one for intensity in missing})
    wall = time.perf_counter() - t0
    images = len(first_x) * len(missing)
    print(f"noise sweep {diff.save_name()}: sampled {len(missing)} "
          f"intensities x {len(first_x)} images x {tau_test} iterations "
          f"on {diff.net.device} in {wall:.3f} s "
          f"({images / max(wall, 1e-9):.2f} images/s)")
    for intensity in missing:
        common.save_outp(diff, args, grids[intensity], intensity)
    return grids


def _run_noise_sweep(args, *, noise_types, intensities, tau_test,
                     gen_img_count, real_img_count):
    device = resolve_device(args.device)
    label = args.label
    args.save_path = args.save_path + str(label) + "/noise_"
    args.load_path = args.load_path + str(label) + "/noise_"
    noise_save_path, noise_load_path = args.save_path, args.load_path
    args.save_path = noise_save_path + "0"
    args.load_path = noise_load_path + "0"

    x_all, y_all, height, width = common.load_dataset(args)
    x_lab = x_all[y_all == label]
    if len(x_lab) == 0:
        raise ValueError(
            f"label {label} has no images in dataset {args.data!r} "
            f"(available labels: {sorted(set(int(v) for v in y_all))})")
    x_lab = x_lab[: int(len(x_lab) * args.reduced_size)]
    cutoff = int(len(x_lab) * 0.8)
    x_train, x_test = x_lab[:cutoff], x_lab[cutoff:]
    first_x = common.make_first_x(args)
    if args.batch_size > len(x_train):
        args.batch_size = max(len(x_train), 1)

    # --- train clean ------------------------------------------------------
    trained = {}
    init_batch = x_train[:32].reshape(-1, 1, height, width)
    for mi, model_args in enumerate(args.model):
        model_name = model_args[0]
        net = common.build_model(model_args, seed=args.seed, device=device,
                                 init_batch=init_batch)
        args.lr = common.model_lr(args, model_name)
        diff = Diffusion(net, add_normal_noise_multiple, args.target,
                         (height, width))
        loss_values, start_epoch = load_diffusion(
            diff, args.load_path, label,
            backend="auto" if args.ckpt_backend == "pt" else "orbax")
        loss_values = common.train(diff, args, x_train, start_epoch,
                                   loss_values)
        trained[mi] = (model_name, diff, loss_values)

    # --- noisy test sweep -------------------------------------------------
    n_dup = {m[0]: [x[0] for x in args.model].count(m[0])
             for m in args.model}
    rkeys = {mi: (m[0] if n_dup[m[0]] == 1 else f"{m[0]}#{mi}")
             for mi, m in enumerate(args.model)}
    results = {rkeys[mi]: {} for mi in rkeys}
    for add_noise in noise_types:
        for rk in results:
            results[rk][add_noise] = {
                "ssim": [], "psnr": [], "cos": [], "fid": []}
        # the caches live under noise_<type> (the reference switches
        # load_path around test(), src/mnist_noise.py:502-504)
        args.save_path = noise_save_path + str(add_noise)
        args.load_path = noise_load_path + str(add_noise)
        for mi in range(len(args.model)):
            _, diff_clean, _ = trained[mi]
            noisy_net = common.with_noise(
                diff_clean.net, add_noise, float(intensities[0]),
                noise_trajectories=(args.n_traj if args.noise_backend
                                    == "traj" else 0))
            diff = Diffusion(noisy_net, add_normal_noise_multiple,
                             args.target, (height, width))
            grids = _sample_grids(diff, args, first_x, tau_test, intensities)
            t0 = time.perf_counter()
            r = results[rkeys[mi]][add_noise]
            for intensity in intensities:
                print(f"\nTest for add_noise: {add_noise}, "
                      f"intensity {intensity}")
                generated, real = common.test(
                    diff, args, x_train, x_test, first_x,
                    tau_test=tau_test, save_images=False,
                    grid=grids[intensity], protocol=common.NOISE_PROTOCOL)
                # the results keep each score's last iteration only, so
                # only the last is scored (the FID's sqrtm of a pixels x
                # pixels matrix dominates the host's work)
                last = generated[-1:]
                r["ssim"].append(float(metrics.ssim_iterations(
                    last, real, gen_img_count, real_img_count)[-1]))
                r["psnr"].append(float(metrics.psnr_iterations(
                    last, real, gen_img_count, real_img_count)[-1]))
                r["cos"].append(float(metrics.cosine_iterations(
                    last, real, gen_img_count, real_img_count)[-1]))
                r["fid"].append(float(metrics.fid_iterations(
                    last, real, gen_img_count, real_img_count)[-1]))
            print(f"noise sweep {diff.save_name()}: scored "
                  f"{len(intensities)} intensities in "
                  f"{time.perf_counter() - t0:.3f} s on the host")
        # metric-vs-intensity plots (reference src/mnist_noise.py:537-540)
        xlabel = NOISE_TYPE_LABELS.get(add_noise, "noise intensity")
        if not metrics.plots_available():
            print(metrics.NO_PLOTS.format(
                what=f"noise type {add_noise} ({xlabel}): the "
                     f"metric-vs-intensity plots"))
            continue
        for metric_name in ("ssim", "psnr", "cos", "fid"):
            curve_dict = {m: results[m][add_noise][metric_name]
                          for m in results}
            metrics.show_metrics(curve_dict, metric_name.upper(), args,
                                 model_name=f"noise{add_noise}",
                                 model_params=[metric_name],
                                 xlabel=xlabel, x_values=list(intensities))
    return results
