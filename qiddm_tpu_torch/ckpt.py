"""Checkpoints in the JAX package's layout (counterpart of
``qiddm_tpu/ckpt.py:24-64, 368-404``).

A checkpoint is a pickle of ``{"model_state_dict": <numpy tree of the flax
variables>, "loss_values": [...], "epochs": int}`` under a ``.pt`` name, so
one file serves both packages: the sampling CLIs of ``qiddm_tpu/`` and
``qiddm_tpu_torch/`` read what either one wrote.
:func:`load_jax_variables` and :func:`export_jax_variables` carry weights
between the flax tree and a port module: flax Dense kernels are (in, out),
``nn.Linear`` weights are (out, in).
"""

from __future__ import annotations

import pathlib
import pickle
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


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
    """{port parameter name: (flax path, transpose?)} for ``net.module``.

    ``linear_down.weight`` <-> params/linear_down/kernel (transposed),
    ``linear_down.bias`` <-> params/linear_down/bias, ``qweights`` <->
    params/qweights."""
    out = {}
    for name, _ in net.module.named_parameters():
        *mods, leaf = name.split(".")
        if mods and leaf == "weight":
            out[name] = (("params", *mods, "kernel"), True)
        else:
            out[name] = (("params", *mods, leaf), False)
    return out


def _flatten(tree, prefix=()) -> Dict[tuple, Any]:
    if isinstance(tree, Mapping):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, prefix + (k,)))
        return flat
    return {prefix: tree}


def load_jax_variables(net, variables) -> None:
    """Copy the JAX model's variables (a numpy tree) into ``net``'s
    parameters, in place. Raises on unknown or missing keys and on shape
    mismatches."""
    flat = _flatten(variables)
    paths = _flax_paths(net)
    want = {path for path, _ in paths.values()}
    if set(flat) != want:
        raise ValueError(
            f"checkpoint does not match {net.save_name()}: unknown "
            f"{sorted(set(flat) - want)}, missing {sorted(want - set(flat))}")
    params = dict(net.module.named_parameters())
    with torch.no_grad():
        for name, (path, transpose) in paths.items():
            value = np.asarray(flat[path])
            if transpose:
                value = value.T
            p = params[name]
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(
                    f"{'/'.join(path)}: checkpoint shape {value.shape} "
                    f"does not fit {name} of shape {tuple(p.shape)}")
            p.copy_(torch.tensor(value, dtype=p.dtype))


def export_jax_variables(net) -> Dict[str, Any]:
    """The inverse of :func:`load_jax_variables`: ``net``'s parameters as
    the JAX model's numpy variables tree."""
    tree: Dict[str, Any] = {}
    params = dict(net.module.named_parameters())
    for name, (path, transpose) in _flax_paths(net).items():
        value = params[name].detach().cpu().numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(value.T if transpose else value)
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
