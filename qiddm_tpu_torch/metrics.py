"""Image scores: SSIM, PSNR, cosine and the pixel-space FID (counterpart of
``qiddm_tpu/metrics.py:28-197``), in numpy on the host.

The reference scores with skimage's ``structural_similarity`` and
``peak_signal_noise_ratio``, a hand-written cosine mapped to [0, 1], and a
Fréchet distance of raw pixels (not Inception features; reference
src/metrics.py:345-356). SSIM keeps skimage's defaults, as the JAX package
does: a 7x7 uniform window over the valid region, K1 = 0.01, K2 = 0.03, the
unbiased covariance, and the data range of each generated image. The FID
runs scipy's ``sqrtm`` on the host, as in the JAX package.

Inputs: generated images (iters, n_gen, 1, H, W) and real images
(n_real, 1, H, W); each ``*_iterations`` returns one score per iteration,
the mean over every (generated, real) pair. The reference's dict API
(``get_ssim``, ``get_psnr``, ``get_cosine_similarity``, ``get_fid`` and
``map_model_name``; ``qiddm_tpu/metrics.py:204-269``) scores a dict of
models at once and, given the drivers' ``args``, plots each curve. The
plots (``show_metrics``, ``show_images``, ``show_histogram``;
``qiddm_tpu/metrics.py:272-383``) draw with matplotlib's Agg backend and
raise ``ImportError`` without it, as the JAX ones do; the drivers ask
:func:`plots_available` once and, where it is false (the card's machine
has no matplotlib), print one line instead of plotting.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np

# what the drivers print in place of a plot on a host without matplotlib
NO_PLOTS = "{what}: skipped, matplotlib cannot be imported on this host"


@functools.lru_cache(maxsize=None)
def plots_available() -> bool:
    """Whether matplotlib can be imported (asked once a process)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _valid_mean7(img: np.ndarray) -> np.ndarray:
    """7x7 uniform filter over the valid region (skimage's crop), on the
    last two axes, through an integral image."""
    c = np.cumsum(np.cumsum(img, axis=-2), axis=-1)
    pad = [(0, 0)] * (img.ndim - 2) + [(1, 0), (1, 0)]
    c = np.pad(c, pad)
    s = (c[..., 7:, 7:] - c[..., :-7, 7:] - c[..., 7:, :-7]
         + c[..., :-7, :-7])
    return s / 49.0


def ssim_pair(im1, im2, data_range) -> np.ndarray:
    """SSIM of two images (or two stacks of them, on the last two axes)
    with skimage's defaults; ``data_range`` broadcasts over the stack."""
    im1 = np.asarray(im1, dtype=np.float64)
    im2 = np.asarray(im2, dtype=np.float64)
    cov_norm = 49.0 / 48.0
    ux, uy = _valid_mean7(im1), _valid_mean7(im2)
    uxx, uyy = _valid_mean7(im1 * im1), _valid_mean7(im2 * im2)
    uxy = _valid_mean7(im1 * im2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    r = np.asarray(data_range, dtype=np.float64)[..., None, None]
    c1, c2 = (0.01 * r) ** 2, (0.03 * r) ** 2
    num = (2.0 * ux * uy + c1) * (2.0 * vxy + c2)
    den = (ux * ux + uy * uy + c1) * (vx + vy + c2)
    return (num / den).mean(axis=(-2, -1))


def _pairs(generated_images, real_images, gen_img_count, real_img_count):
    """(I, G, H, W) generated and (R, H, W) real, cut to the counts."""
    gen = np.asarray(generated_images, dtype=np.float32)[:, :, 0]
    real = np.asarray(real_images, dtype=np.float32)[:, 0]
    if gen_img_count is not None:
        gen = gen[:, :gen_img_count]
    if real_img_count is not None:
        real = real[:real_img_count]
    return gen, real


def _gen_range(gen: np.ndarray) -> np.ndarray:
    """Each generated image's data range, max - min: (I, G)."""
    return gen.max(axis=(-2, -1)) - gen.min(axis=(-2, -1))


def ssim_iterations(generated_images, real_images, gen_img_count=None,
                    real_img_count=None) -> np.ndarray:
    """Mean SSIM per denoise iteration over every (generated, real) pair,
    the data range taken from the generated image (reference
    src/metrics.py:230-242)."""
    gen, real = _pairs(generated_images, real_images, gen_img_count,
                       real_img_count)
    dr = _gen_range(gen)[:, :, None]                     # (I, G, 1)
    vals = ssim_pair(gen[:, :, None], real[None, None], dr)
    return vals.mean(axis=(1, 2))


def psnr_iterations(generated_images, real_images, gen_img_count=None,
                    real_img_count=None) -> np.ndarray:
    """Mean PSNR per iteration, ``10 log10(R^2 / mse)`` with R the
    generated image's data range."""
    gen, real = _pairs(generated_images, real_images, gen_img_count,
                       real_img_count)
    g = gen.astype(np.float64)[:, :, None]
    err = ((real.astype(np.float64)[None, None] - g) ** 2).mean(
        axis=(-2, -1))
    r = _gen_range(gen).astype(np.float64)[:, :, None]
    return (10.0 * np.log10(r * r / err)).mean(axis=(1, 2))


def cosine_iterations(generated_images, real_images, gen_img_count=None,
                      real_img_count=None) -> np.ndarray:
    """Mean ``0.5 + 0.5 cos`` per iteration (reference
    src/metrics.py:162-209)."""
    gen, real = _pairs(generated_images, real_images, gen_img_count,
                       real_img_count)
    g = gen.reshape(gen.shape[0], gen.shape[1], -1).astype(np.float64)
    r = real.reshape(real.shape[0], -1).astype(np.float64)
    num = np.einsum("igp,rp->igr", g, r)
    cos = num / (np.linalg.norm(g, axis=-1)[:, :, None]
                 * np.linalg.norm(r, axis=-1)[None, None, :])
    return (0.5 + 0.5 * cos).mean(axis=(1, 2))


def _cov(act: np.ndarray):
    """``np.cov(act, rowvar=False)`` as numpy before 2.2 computes it. A
    single image (one row, as the noise drivers score with one generated
    image) is there one variable observed at every pixel, so the
    covariance is the scalar variance of its pixels; numpy 2.2 and later
    read the row as one observation of every pixel and return a matrix of
    NaN. The JAX package calls ``np.cov`` directly, so the two agree on a
    one-image FID only on a numpy before 2.2."""
    if act.shape[0] == 1:
        return np.cov(act[0])
    return np.cov(act, rowvar=False)


def calculate_fid(act1, act2, n1=None, n2=None) -> float:
    """Pixel-space Fréchet distance (reference src/metrics.py:345-356):
    mean and covariance of the raw flattened pixels, scipy's ``sqrtm`` on
    the host."""
    from scipy.linalg import sqrtm

    act1 = np.asarray(act1).reshape(n1 or len(act1), -1)
    act2 = np.asarray(act2).reshape(n2 or len(act2), -1)
    mu1, sigma1 = act1.mean(axis=0), _cov(act1)
    mu2, sigma2 = act2.mean(axis=0), _cov(act2)
    ssdiff = np.sum((mu1 - mu2) ** 2.0)
    covmean = sqrtm(sigma1.dot(sigma2))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(ssdiff + np.trace(sigma1 + sigma2 - 2.0 * covmean))


def fid_iterations(generated_images, real_images, gen_img_count=None,
                   real_img_count=None) -> np.ndarray:
    """:func:`calculate_fid` of each iteration's generated images against
    the real ones."""
    gen = np.asarray(generated_images)
    real = np.asarray(real_images)
    if gen_img_count is not None:
        gen = gen[:, :gen_img_count]
    if real_img_count is not None:
        real = real[:real_img_count]
    return np.asarray([calculate_fid(gen[it], real, gen.shape[1],
                                     real.shape[0])
                       for it in range(gen.shape[0])])


def map_model_name(model_name):
    """The papers' name of a model (reference src/metrics.py:24-59)."""
    mapping = {
        "UNetUndirected": "U-net",
        "differN_noise": "QIDDMA",
        "QDenseUndirected_old_noise": "Qdense",
        "QIDDM_PL_noise": "QIDDML",
        "QNN_noise": "QNN",
    }
    if model_name is None:
        return model_name
    if model_name in mapping:
        return mapping[model_name]
    low = model_name.lower()
    for part, name in (("differn", "QIDDMA"), ("qdenseundirected", "Qdense"),
                       ("qiddm_pl", "QIDDML"), ("qnn", "QNN"),
                       ("unet_undirected", "U-net")):
        if part in low:
            return name
    return model_name


def _dict_metric(metric_fn, generated_images_dict, real_images_dict, args,
                 gen_img_count, real_img_count, name):
    """``{model: [score per iteration]}`` of ``metric_fn`` over a dict of
    generated grids and their real images; given ``args``, also the plot
    of the curves (:func:`show_metrics`), as ``qiddm_tpu/metrics.py:
    183-193``."""
    values = {
        model: [float(v) for v in metric_fn(
            gen, real_images_dict[model], gen_img_count, real_img_count)]
        for model, gen in generated_images_dict.items()}
    if args is not None:
        show_metrics(values, name, args,
                     model_name=list(generated_images_dict)[-1]
                     if generated_images_dict else None)
    return values


def get_ssim(generated_images_dict, real_images_dict, args=None,
             gen_img_count=None, real_img_count=None):
    return _dict_metric(ssim_iterations, generated_images_dict,
                        real_images_dict, args, gen_img_count,
                        real_img_count, "SSIM")


def get_psnr(generated_images_dict, real_images_dict, args=None,
             gen_img_count=None, real_img_count=None):
    return _dict_metric(psnr_iterations, generated_images_dict,
                        real_images_dict, args, gen_img_count,
                        real_img_count, "PSNR")


def get_cosine_similarity(generated_images_dict, real_images_dict, args=None,
                          gen_img_count=None, real_img_count=None):
    return _dict_metric(cosine_iterations, generated_images_dict,
                        real_images_dict, args, gen_img_count,
                        real_img_count, "Cosine Similarity")


def get_fid(generated_images_dict, real_images_dict, args=None,
            gen_img_count=None, real_img_count=None):
    return _dict_metric(fid_iterations, generated_images_dict,
                        real_images_dict, args, gen_img_count,
                        real_img_count, "fid")


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def show_metrics(values_dict, name, args, model_name=None, model_params=None,
                 colors=None, legend_labels=None, xlabel=None, ylabel=None,
                 is_loss=False, marker_size=7, line_width=3, x_values=None):
    """Line plot per model (reference src/metrics.py:104-153), saved as
    ``<args.save_path>/<name>_<info>_<args.label>.png`` when ``args`` has a
    save path.

    ``x_values``: explicit x coordinates (e.g. the physical noise
    intensities of a sweep); default is the index.
    """
    plt = _pyplot()
    colors = colors or ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728",
                        "#9467bd", "#7f7f7f"]
    legend_labels = [map_model_name(l) for l in
                     (legend_labels or list(values_dict.keys()))]
    xlabel = xlabel or ("Epochs" if is_loss else "Denoising steps")
    markers = ["o", "s", "^", "d", "x", "*", "+", "v", "<", ">", "p", "h"]
    plt.figure(figsize=(8, 6))
    for idx, (_, values) in enumerate(values_dict.items()):
        kw = dict(linestyle="-", color=colors[idx % len(colors)],
                  linewidth=line_width,
                  label=legend_labels[idx % len(legend_labels)])
        if not is_loss:
            kw.update(marker=markers[idx % len(markers)],
                      markersize=marker_size)
        xs = x_values if x_values is not None else range(len(values))
        plt.plot(xs, values, **kw)
    plt.title(name, fontsize=24)
    plt.xlabel(xlabel, fontsize=22)
    plt.ylabel(ylabel or name, fontsize=22)
    plt.grid(True)
    plt.legend(fontsize=18)
    if args is not None and getattr(args, "save_path", None):
        info = (f"{model_name}_{'_'.join(map(str, model_params))}"
                if model_name and model_params else str(model_name))
        sp = pathlib.Path(args.save_path) / f"{name}_{info}_{args.label}.png"
        sp.parent.mkdir(parents=True, exist_ok=True)
        plt.tight_layout()
        plt.savefig(sp, dpi=300)
        print(f"{name} plot saved to {sp}")
    plt.close()


def show_images(images, num_images=5, img_size=(8, 8), save_path=None):
    """Row of grayscale images (reference src/metrics.py:358-372)."""
    plt = _pyplot()
    num = min(num_images, len(images))
    fig, axes = plt.subplots(1, num, figsize=(15, 3))
    if num == 1:
        axes = [axes]
    for i in range(num):
        img = images[i]
        img = img.detach().cpu().numpy() if hasattr(img, "detach") else img
        axes[i].imshow(np.asarray(img).reshape(img_size), cmap="gray")
        axes[i].axis("off")
    if save_path:
        plt.savefig(save_path)
    plt.close(fig)


def show_histogram(score_dict, metric, args, model_name=None,
                   model_params=None, filename=None):
    """Grouped bar chart across labels (reference src/metrics.py:62-101),
    saved as ``<args.save_path>/<metric>_<info>_<args.label>.png`` when
    ``args`` has a save path."""
    plt = _pyplot()
    models = list(score_dict.keys())
    scores = np.array(list(score_dict.values()))
    num_models = len(models)
    num_labels = len(scores[0])
    x = np.arange(num_labels)
    bar_width = 0.5 / num_models
    colors = ["#9FABB9", "#D4E1F5", "#7EA6E0", "#D3E2B7", "#7CB862",
              "#FFCE9F", "#9467bd", "#7f7f7f"]
    plt.figure(figsize=(12, 6))
    for i, model in enumerate(models):
        label = map_model_name(model)
        for j in range(num_labels):
            plt.bar(x[j] + i * bar_width, scores[i, j], width=bar_width,
                    color=colors[i % len(colors)],
                    label=label if j == 0 else "")
    plt.title(f"{metric} of Models Across Labels", fontsize=18)
    plt.xlabel(f"{getattr(args, 'data', '')} Labels" if args is not None
               else "Labels", fontsize=16)
    plt.ylabel(metric, fontsize=16)
    # reference xtick/ylim protocol (src/metrics.py:85-91): 'Label i' ticks
    # centered under each bar group, y capped at 1.1x the max score
    plt.xticks(x + bar_width * (num_models - 1) / 2,
               [f"Label {i}" for i in range(num_labels)], fontsize=14)
    plt.yticks(fontsize=14)
    plt.legend(fontsize=14, markerscale=1.5)
    max_score = np.max(scores) if scores.size else 1.0
    plt.ylim(0, max_score * 1.1)
    if args is not None and getattr(args, "save_path", None):
        info = (f"{map_model_name(model_name)}_"
                f"{'_'.join(map(str, model_params))}"
                if model_name and model_params else "unknown_model")
        sp = pathlib.Path(args.save_path) / f"{metric}_{info}_{args.label}.png"
        sp.parent.mkdir(parents=True, exist_ok=True)
        plt.tight_layout()
        plt.savefig(sp, dpi=300)
    plt.close()
