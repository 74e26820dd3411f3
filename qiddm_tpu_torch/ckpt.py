"""Checkpoints in the JAX package's layout (counterpart of
``qiddm_tpu/ckpt.py:24-64, 368-404``).

A checkpoint is a pickle of ``{"model_state_dict": <numpy tree of the flax
variables>, "loss_values": [...], "epochs": int}`` under a ``.pt`` name, so
one file serves both packages: the sampling CLIs of ``qiddm_tpu/`` and
``qiddm_tpu_torch/`` read what either one wrote.
:func:`load_jax_variables` and :func:`export_jax_variables` carry weights
and state between the flax tree and a port module (``_flax_paths`` maps
each by layer kind: Dense kernels, conv kernels, BatchNorm scales and
statistics, a lazy PCA, at any depth of nesting, as the U-Net's blocks
have it). A noisy model's explicit intensity
travels as the flax ``noise_cfg/intensity`` variable (a float32 scalar),
which the port keeps as ``net.module.noise_intensity``.
"""

from __future__ import annotations

import pathlib
import pickle
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .nn.core import LazyPCA
from .nn.layers import FlaxBatchNorm


def save_checkpoint(path, variables, loss_values: List[float], epochs: int,
                    extra: Optional[Dict[str, Any]] = None) -> pathlib.Path:
    """Write ``variables`` (a numpy tree, e.g. from
    :func:`export_jax_variables`) in the JAX package's pickle layout."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blob = {
        "model_state_dict": variables,
        "loss_values": list(loss_values),
        "epochs": int(epochs),
    }
    if extra:
        blob.update(extra)
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    return path


def load_checkpoint(path) -> Dict[str, Any]:
    """Read a checkpoint pickle. Unpickling runs code: load only files
    this project wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)


def _flax_paths(net) -> Dict[str, tuple]:
    """{port state name: (flax path, layout)} for ``net.module``'s
    parameters and buffers, each under its module's dotted path as nested
    flax scopes (the U-Net's ``down0.conv1`` is ``down0/conv1``), by layer
    kind:

    * a ``Linear`` weight (out, in) <-> params/<name>/kernel (in, out),
      layout "linear" (transposed);
    * a ``Conv2d`` weight (O, I, kh, kw) <-> params/<name>/Conv_0/kernel
      (kh, kw, I, O), layout "conv"; its bias <-> params/<name>/Conv_0/bias;
    * a BatchNorm's weight and bias <-> params/<name>/{scale,bias}, its
      running statistics <-> batch_stats/<name>/{mean,var};
    * a lazy PCA's buffers <-> pca_state/{mean,components};
    * anything else (a dense or QConv2d ``qweights``, a Linear's bias)
      under its own name, layout None.

    So a U-Net maps as its flax tree nests: ``params/down{i}/conv{j}/
    Conv_0/{kernel,bias}`` (classical) or ``params/down{i}/conv{j}/
    qweights`` (quantum), ``params/.../bn{j}/{scale,bias}`` and
    ``batch_stats/.../bn{j}/{mean,var}``, ``up{i}/up_conv``,
    ``final_conv`` and the simple blocks' ``qconv``/``up_qconv``/``bn``."""
    out = {}
    for mname, mod in net.module.named_modules():
        mods = tuple(mname.split(".")) if mname else ()
        for leaf, _ in mod.named_parameters(recurse=False):
            name = f"{mname}.{leaf}" if mname else leaf
            layout = None
            if isinstance(mod, torch.nn.Conv2d):
                path = (*mods, "Conv_0",
                        "kernel" if leaf == "weight" else leaf)
                layout = "conv" if leaf == "weight" else None
            elif isinstance(mod, torch.nn.Linear) and leaf == "weight":
                path, layout = (*mods, "kernel"), "linear"
            elif isinstance(mod, FlaxBatchNorm) and leaf == "weight":
                path = (*mods, "scale")
            else:
                path = (*mods, leaf)
            out[name] = (("params", *path), layout)
        for leaf, _ in mod.named_buffers(recurse=False):
            name = f"{mname}.{leaf}" if mname else leaf
            if isinstance(mod, FlaxBatchNorm):
                stat = {"running_mean": "mean", "running_var": "var"}[leaf]
                out[name] = (("batch_stats", *mods, stat), None)
            elif isinstance(mod, LazyPCA):
                out[name] = (("pca_state", *mods[:-1], leaf), None)
            else:
                raise ValueError(f"{name}: a buffer with no flax variable")
    return out


def _to_port(value: np.ndarray, layout) -> np.ndarray:
    if layout == "linear":
        return value.T
    if layout == "conv":
        return value.transpose(3, 2, 0, 1)
    return value


def _to_flax(value: np.ndarray, layout) -> np.ndarray:
    if layout == "linear":
        return value.T
    if layout == "conv":
        return value.transpose(2, 3, 1, 0)
    return value


def _flatten(tree, prefix=()) -> Dict[tuple, Any]:
    if isinstance(tree, Mapping):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, prefix + (k,)))
        return flat
    return {prefix: tree}


_NOISE_PATH = ("noise_cfg", "intensity")


def load_jax_variables(net, variables) -> None:
    """Copy the JAX model's variables (a numpy tree) into ``net``'s
    parameters and buffers (``params``, ``batch_stats`` and ``pca_state``),
    in place, and a ``noise_cfg/intensity`` into
    ``net.module.noise_intensity`` (a 0-d float32 tensor on the module's
    device). Raises on unknown or missing keys and on shape mismatches."""
    flat = _flatten(variables)
    noise = flat.pop(_NOISE_PATH, None)
    paths = _flax_paths(net)
    want = {path for path, _ in paths.values()}
    if set(flat) != want:
        raise ValueError(
            f"checkpoint does not match {net.save_name()}: unknown "
            f"{sorted(set(flat) - want)}, missing {sorted(want - set(flat))}")
    state = {**dict(net.module.named_parameters()),
             **dict(net.module.named_buffers())}
    with torch.no_grad():
        for name, (path, layout) in paths.items():
            value = _to_port(np.asarray(flat[path]), layout)
            p = state[name]
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(
                    f"{'/'.join(path)}: checkpoint shape {value.shape} "
                    f"does not fit {name} of shape {tuple(p.shape)}")
            p.copy_(torch.tensor(value, dtype=p.dtype))
    if noise is not None:
        value = np.asarray(noise, dtype=np.float32)
        if value.shape != ():
            raise ValueError(f"{'/'.join(_NOISE_PATH)}: a scalar, got shape "
                             f"{value.shape}")
        net.module.noise_intensity = torch.tensor(
            value, device=next(net.module.parameters()).device)


def export_jax_variables(net) -> Dict[str, Any]:
    """The inverse of :func:`load_jax_variables`: ``net``'s parameters and
    buffers, and an explicit noise intensity as ``noise_cfg/intensity``,
    as the JAX model's numpy variables tree."""
    tree: Dict[str, Any] = {}
    state = {**dict(net.module.named_parameters()),
             **dict(net.module.named_buffers())}
    for name, (path, layout) in _flax_paths(net).items():
        value = state[name].detach().cpu().numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(_to_flax(value, layout))
    # the JAX module makes the variable only for a noisy circuit
    intensity = getattr(net.module, "noise_intensity", None)
    if intensity is not None and net.module.add_noise != 0:
        if torch.is_tensor(intensity):
            intensity = intensity.detach().cpu().numpy()
        tree[_NOISE_PATH[0]] = {_NOISE_PATH[1]: np.asarray(intensity,
                                                           np.float32)}
    return tree


_ORBAX = "the orbax checkpoint backend is ROADMAP Queue 1 item 10"


def save_diffusion(diff, save_path, label, loss_values, epochs,
                   backend: str = "pt"):
    """Driver-level save (reference src/mnist_exm.py:189-201):
    ``<save_path>/<save_name>_<label>.pt`` in the shared pickle layout."""
    if backend != "pt":
        raise NotImplementedError(f"backend={backend!r}: {_ORBAX}")
    sp = pathlib.Path(save_path) / f"{diff.save_name()}_{label}.pt"
    return save_checkpoint(sp, export_jax_variables(diff.net),
                           [float(v) for v in loss_values], epochs)


def load_diffusion(diff, load_path, label,
                   backend: str = "auto") -> Tuple[List[float], int]:
    """Driver-level load; returns (loss_values, start_epoch) and keeps the
    fresh model when the file is missing (reference
    src/mnist_exm.py:294-323). ``load_path`` is a directory, or a ``.pt``
    file."""
    if backend not in ("auto", "pt"):
        raise NotImplementedError(f"backend={backend!r}: {_ORBAX}")
    if str(load_path).endswith(".pt"):
        lp = pathlib.Path(load_path)
    else:
        base = pathlib.Path(load_path)
        op = base / f"{diff.save_name()}_{label}.orbax"
        if op.exists():
            raise NotImplementedError(f"{op} is an orbax checkpoint: "
                                      f"{_ORBAX}")
        lp = base / f"{diff.save_name()}_{label}.pt"
    print(lp)
    try:
        ckpt = load_checkpoint(lp)
    except FileNotFoundError:
        print("Failed to load model: File not found.\n")
        return [], 0
    load_jax_variables(diff.net, ckpt["model_state_dict"])
    print("Model loaded successfully.\n")
    return ckpt.get("loss_values", []), ckpt.get("epochs", 0)
