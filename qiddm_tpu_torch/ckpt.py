"""Checkpoints (counterpart of ``qiddm_tpu/ckpt.py``): the JAX package's
pickle layout, the reference's torch ``.pt`` state dicts, and a
``torch.distributed.checkpoint`` counterpart of the orbax backend.

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

import os
import pathlib
import pickle
import threading
import warnings
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


# --- the reference's torch state dicts (qiddm_tpu/ckpt.py:67-365) ----------
#
# The reference's names go to and from the flax variables tree exactly as
# the JAX package maps them; the tree goes to and from the port's modules
# through export_jax_variables / load_jax_variables.

def import_torch_state_dict(net, state_dict, strict: bool = True):
    """Map a REFERENCE torch ``state_dict`` onto a port model, in place
    (counterpart of ``qiddm_tpu/ckpt.py:67-174``).

    Supports the checkpoints the reference ships and any its training
    scripts produce: the quantum-dense families (weights/weights1 +
    linear_down/linear_up + batchnorm), conv down-projections, and the
    U-Net family (Sequential-indexed convs and BatchNorms). Tensors convert
    with the torch->flax layout rules (Linear kernels transpose; Conv
    OIHW -> HWIO) into the flax tree, which :func:`load_jax_variables`
    copies into ``net``. ``strict`` raises on a reference tensor the
    mapping does not consume.

    Returns the flax variables tree that was loaded.
    """
    sd = {}
    for key, v in state_dict.items():
        k = key[4:] if key.startswith("net.") else key
        sd[k] = np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v)
                           else v)

    variables = export_jax_variables(net)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    consumed = set()

    def take(k):
        consumed.add(k)
        return sd[k]

    def set_linear(dst, prefix):
        if f"{prefix}.weight" in sd:
            dst["kernel"] = take(f"{prefix}.weight").T.astype(
                dst["kernel"].dtype)
        if f"{prefix}.bias" in sd and "bias" in dst:
            dst["bias"] = take(f"{prefix}.bias").astype(dst["bias"].dtype)

    def set_conv(dst, prefix):
        if "qweights" in dst:
            # quantum conv: torch QConv2d stores one SEL weight tensor
            dst["qweights"] = take(f"{prefix}.weights").astype(
                dst["qweights"].dtype)
            return
        dst = dst["Conv_0"] if "Conv_0" in dst else dst
        # torch OIHW -> flax HWIO
        dst["kernel"] = take(f"{prefix}.weight").transpose(2, 3, 1, 0).astype(
            dst["kernel"].dtype)
        if f"{prefix}.bias" in sd:
            dst["bias"] = take(f"{prefix}.bias").astype(dst["bias"].dtype)

    def set_bn(pdst, sdst, prefix):
        pdst["scale"] = take(f"{prefix}.weight").astype(pdst["scale"].dtype)
        pdst["bias"] = take(f"{prefix}.bias").astype(pdst["bias"].dtype)
        sdst["mean"] = take(f"{prefix}.running_mean").astype(
            sdst["mean"].dtype)
        sdst["var"] = take(f"{prefix}.running_var").astype(sdst["var"].dtype)
        consumed.add(f"{prefix}.num_batches_tracked")

    # --- quantum-dense families ------------------------------------------
    for wkey in ("weights", "weights1"):
        if wkey in sd and "qweights" in params:
            params["qweights"] = take(wkey).astype(
                params["qweights"].dtype).reshape(params["qweights"].shape)
    if "linear_down.weight" in sd and "linear_down" in params:
        set_linear(params["linear_down"], "linear_down")
    if "linear_up.weight" in sd and "linear_up" in params:
        set_linear(params["linear_up"], "linear_up")
    if "conv_layer.weight" in sd and "conv_down" in params:
        set_conv(params["conv_down"], "conv_layer")
    for bn_src, bn_dst in (("batchnorm", "bn"), ("batch_norm", "pca_bn")):
        if f"{bn_src}.weight" in sd and bn_dst in params:
            set_bn(params[bn_dst], stats[bn_dst], bn_src)

    # --- U-Net family ------------------------------------------------------
    # reference Sequential indices: DownBlock net = [conv,bn,relu,conv,bn,
    # relu] -> (0,1,3,4); UpBlock net = [conv,relu,bn,conv,bn,relu] ->
    # (0,2,3,4); up_conv = [Upsample, conv] -> (1,). The simple (S) blocks
    # are net = [QConv2d, BatchNorm] -> (0,1) (reference nn/unet_simple.py).
    for name in sorted(params):  # flax's key order
        if name.startswith("down"):
            i = name[4:]
            blk = f"down_blocks.{i}.net"
            if "qconv" in params[name]:  # SimpleDownBlock
                set_conv(params[name]["qconv"], f"{blk}.0")
                set_bn(params[name]["bn"], stats[name]["bn"], f"{blk}.1")
            else:
                set_conv(params[name]["conv0"], f"{blk}.0")
                set_bn(params[name]["bn0"], stats[name]["bn0"], f"{blk}.1")
                set_conv(params[name]["conv1"], f"{blk}.3")
                set_bn(params[name]["bn1"], stats[name]["bn1"], f"{blk}.4")
        elif name.startswith("up") and name != "up_conv":
            i = name[2:]
            blk = f"up_blocks.{i}"
            if "qconv" in params[name]:  # SimpleUpBlock
                set_conv(params[name]["up_qconv"], f"{blk}.up_conv.1")
                set_conv(params[name]["qconv"], f"{blk}.net.0")
                set_bn(params[name]["bn"], stats[name]["bn"], f"{blk}.net.1")
            else:
                set_conv(params[name]["up_conv"], f"{blk}.up_conv.1")
                set_conv(params[name]["conv0"], f"{blk}.net.0")
                set_bn(params[name]["bn0"], stats[name]["bn0"], f"{blk}.net.2")
                set_conv(params[name]["conv1"], f"{blk}.net.3")
                set_bn(params[name]["bn1"], stats[name]["bn1"], f"{blk}.net.4")
        elif name == "final_conv":
            set_conv(params[name], "final_conv")

    leftover = set(sd) - consumed
    if strict and leftover:
        raise ValueError(f"unmapped reference tensors: {sorted(leftover)}")
    load_jax_variables(net, variables)
    return variables


def _reference_weights_key(net) -> str:
    """The reference's quantum-weight attribute name for this model class:
    every ``QIDDM_*`` class declares ``self.weights1`` EXCEPT
    ``QIDDM_A_sameN`` (``self.weights``); all other families use
    ``self.weights`` (grep-verified over reference nn/qdense.py)."""
    name = type(net).__name__
    if name.startswith("QIDDM") and name != "QIDDM_A_sameN":
        return "weights1"
    return "weights"


def export_torch_state_dict(net, weights_key: str = None,
                            prefix: str = "net.", strict: bool = True):
    """Inverse of :func:`import_torch_state_dict`: a reference-named
    torch-style ``state_dict`` (numpy values) of a port model (counterpart
    of ``qiddm_tpu/ckpt.py:189-291``), from its flax variables tree.
    Layouts invert the torch->flax rules (Linear kernels transpose back,
    Conv HWIO -> OIHW).

    ``prefix`` defaults to ``"net."``: the reference drivers save
    ``diff.state_dict()`` of the Diffusion wrapper whose model attribute
    is ``self.net`` (src/mnist_exm.py:197-201, load at :315). Pass
    ``prefix=""`` for the per-model ``Model.load_model`` path (reference
    nn/qdense.py:1862-1870). ``weights_key`` names the quantum weight
    tensor; by default :func:`_reference_weights_key` picks the class's
    reference name. ``strict`` raises if any param leaf was not exported
    (a family the mapping does not know)."""
    if weights_key is None:
        weights_key = _reference_weights_key(net)
    variables = export_jax_variables(net)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = {}
    n_exported = [0]  # param leaves actually written (strict accounting)

    def put_linear(src, pre):
        sd[f"{pre}.weight"] = np.asarray(src["kernel"]).T
        n_exported[0] += 1
        if "bias" in src:
            sd[f"{pre}.bias"] = np.asarray(src["bias"])
            n_exported[0] += 1

    def put_conv(src, pre):
        if "qweights" in src:
            sd[f"{pre}.weights"] = np.asarray(src["qweights"])
            n_exported[0] += 1
            return
        src = src["Conv_0"] if "Conv_0" in src else src
        sd[f"{pre}.weight"] = np.asarray(src["kernel"]).transpose(
            3, 2, 0, 1)  # flax HWIO -> torch OIHW
        n_exported[0] += 1
        if "bias" in src:
            sd[f"{pre}.bias"] = np.asarray(src["bias"])
            n_exported[0] += 1

    def put_bn(psrc, ssrc, pre):
        sd[f"{pre}.weight"] = np.asarray(psrc["scale"])
        sd[f"{pre}.bias"] = np.asarray(psrc["bias"])
        sd[f"{pre}.running_mean"] = np.asarray(ssrc["mean"])
        sd[f"{pre}.running_var"] = np.asarray(ssrc["var"])
        sd[f"{pre}.num_batches_tracked"] = np.asarray(0, np.int64)
        n_exported[0] += 2

    if "qweights" in params:
        sd[weights_key] = np.asarray(params["qweights"])
        n_exported[0] += 1
    if "linear_down" in params:
        put_linear(params["linear_down"], "linear_down")
    if "linear_up" in params:
        put_linear(params["linear_up"], "linear_up")
    if "conv_down" in params:
        put_conv(params["conv_down"], "conv_layer")
    for bn_dst, bn_src in (("bn", "batchnorm"), ("pca_bn", "batch_norm")):
        if bn_dst in params:
            put_bn(params[bn_dst], stats[bn_dst], bn_src)

    for name in sorted(params):  # flax's key order
        if name.startswith("down"):
            i = name[4:]
            blk = f"down_blocks.{i}.net"
            if "qconv" in params[name]:  # SimpleDownBlock
                put_conv(params[name]["qconv"], f"{blk}.0")
                put_bn(params[name]["bn"], stats[name]["bn"], f"{blk}.1")
            else:
                put_conv(params[name]["conv0"], f"{blk}.0")
                put_bn(params[name]["bn0"], stats[name]["bn0"], f"{blk}.1")
                put_conv(params[name]["conv1"], f"{blk}.3")
                put_bn(params[name]["bn1"], stats[name]["bn1"], f"{blk}.4")
        elif name.startswith("up") and name != "up_conv":
            i = name[2:]
            blk = f"up_blocks.{i}"
            if "qconv" in params[name]:  # SimpleUpBlock
                put_conv(params[name]["up_qconv"], f"{blk}.up_conv.1")
                put_conv(params[name]["qconv"], f"{blk}.net.0")
                put_bn(params[name]["bn"], stats[name]["bn"], f"{blk}.net.1")
            else:
                put_conv(params[name]["up_conv"], f"{blk}.up_conv.1")
                put_conv(params[name]["conv0"], f"{blk}.net.0")
                put_bn(params[name]["bn0"], stats[name]["bn0"], f"{blk}.net.2")
                put_conv(params[name]["conv1"], f"{blk}.net.3")
                put_bn(params[name]["bn1"], stats[name]["bn1"], f"{blk}.net.4")
        elif name == "final_conv":
            put_conv(params[name], "final_conv")

    n_total = len(_flatten(params))
    if strict and n_exported[0] != n_total:
        raise ValueError(
            f"export mapped {n_exported[0]} of {n_total} param leaves — "
            f"unknown layer names in {sorted(params)} (pass strict=False "
            f"to export the known subset)")
    return {prefix + k: v for k, v in sd.items()}


def _sklearn_pca():
    try:
        from sklearn.decomposition import PCA
    except ImportError as err:
        raise ImportError(
            "the reference checkpoint of a model with a fitted PCA pickles "
            "an sklearn.decomposition.PCA (reference nn/qdense.py:1852-1870)"
            ": writing or reading it needs scikit-learn, which this host "
            "lacks") from err
    return PCA


def save_reference_checkpoint(net, path, loss_values=None, epochs: int = 0,
                              weights_key: str = None, prefix: str = "net.",
                              strict: bool = True) -> pathlib.Path:
    """Write a reference-compatible torch ``.pt`` checkpoint: the
    ``{'model_state_dict', 'loss_values', 'epochs'}`` dict the reference
    drivers save and load (src/mnist_exm.py:197-201, 294-323; counterpart
    of ``qiddm_tpu/ckpt.py:294-338``).

    A model holding a fitted PCA (the ``pca_state`` collection) also gets
    a pickled ``sklearn.decomposition.PCA`` under the ``pca_state`` key,
    as the reference's ``QIDDM_PP.save_model`` writes it; that needs
    scikit-learn and raises ``ImportError`` without it."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v).copy()) if np.ndim(v)
          else torch.tensor(v)
          for k, v in export_torch_state_dict(
              net, weights_key, prefix=prefix, strict=strict).items()}
    out = {"model_state_dict": sd,
           "loss_values": [float(v) for v in (loss_values or [])],
           "epochs": int(epochs)}
    pca = export_jax_variables(net).get("pca_state")
    if pca:
        PCA = _sklearn_pca()
        comps = np.asarray(pca["components"])
        obj = PCA(n_components=comps.shape[0])
        obj.components_ = comps.astype(np.float64)
        obj.mean_ = np.asarray(pca["mean"], np.float64)
        obj.n_components_ = comps.shape[0]
        obj.n_features_in_ = comps.shape[1]
        obj.whiten = False
        out["pca_state"] = pickle.dumps(obj)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, path)
    return path


def load_reference_checkpoint(net, path, strict: bool = True):
    """Load a reference torch ``.pt`` checkpoint into a port model
    (counterpart of ``qiddm_tpu/ckpt.py:341-365``); returns
    ``(loss_values, epochs)``.

    The file is read with ``torch.load(weights_only=True)``: it holds
    tensors, lists, numbers and, for a PCA model, the pickled sklearn PCA
    as a ``bytes`` blob. That blob is unpickled (which needs scikit-learn
    and runs code: load only files you trust) only when ``net`` holds a
    PCA state."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    import_torch_state_dict(net, sd, strict=strict)
    if "pca_state" in ckpt:
        variables = export_jax_variables(net)
        if "pca_state" in variables:
            _sklearn_pca()
            obj = pickle.loads(ckpt["pca_state"])
            variables["pca_state"] = {
                "mean": np.asarray(obj.mean_, np.float32),
                "components": np.asarray(obj.components_, np.float32),
            }
            load_jax_variables(net, variables)
    return ckpt.get("loss_values", []), ckpt.get("epochs", 0)


# --- the orbax backend's counterpart: torch.distributed.checkpoint ---------
#
# The JAX package's production format is an orbax directory of
# tensorstores (qiddm_tpu/ckpt.py:407-538). The card's machine has neither
# orbax nor tensorstore, so the port's counterpart is its own format: a
# torch.distributed.checkpoint (DCP) directory <save_name>_<label>.dcp of
# the same flax variables tree, with the loss curve and epochs in a
# <...>.dcp.meta.json sidecar. It runs in one process with no process
# group (no_dist=True).

_DCP_SUFFIX = ".dcp"


def _dcp():
    """``torch.distributed.checkpoint``, with its warning that a call with
    ``no_dist=True`` runs in one process silenced: that is the intent (the
    filter is added again at each call, which moves it to the front)."""
    import torch.distributed.checkpoint as dcp

    warnings.filterwarnings(
        "ignore", message="torch.distributed is disabled, unavailable or "
        "uninitialized", category=UserWarning)
    return dcp


def _meta_path(path: pathlib.Path) -> pathlib.Path:
    return pathlib.Path(str(path) + ".meta.json")


def _host_snapshot(variables) -> Dict[str, Any]:
    """The numpy tree as CPU tensors that own their memory: a later
    in-place optimizer step cannot reach them."""
    if isinstance(variables, Mapping):
        return {k: _host_snapshot(v) for k, v in variables.items()}
    return torch.from_numpy(np.array(variables, copy=True))


def _dcp_commit(path: pathlib.Path, state, meta) -> None:
    """Write ``state`` into a temporary directory beside ``path``, swap it
    in, then write the sidecar: a crash leaves either the old checkpoint
    with its old sidecar or the new one, never a new sidecar beside old
    arrays (orbax's tmp-dir rename, qiddm_tpu/ckpt.py:436-457)."""
    import json
    import shutil

    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}-{threading.get_ident()}")
    shutil.rmtree(tmp, ignore_errors=True)
    _dcp().save(state, checkpoint_id=str(tmp), no_dist=True)
    old = None
    if path.exists():
        old = path.with_name(f"{path.name}.old-{os.getpid()}")
        shutil.rmtree(old, ignore_errors=True)
        os.replace(path, old)
    os.replace(tmp, path)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    _meta_path(path).write_text(json.dumps(meta))


class DcpSave:
    """The handle of a :func:`save_dcp`: ``wait_until_finished()`` joins
    the background write and re-raises its error, if any."""

    def __init__(self, thread: Optional[threading.Thread] = None):
        self._thread = thread
        self.error: Optional[BaseException] = None

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
        if self.error is not None:
            raise self.error


def save_dcp(path, variables, *, loss_values=None, epochs: int = 0,
             async_save: bool = False) -> DcpSave:
    """Write ``variables`` (a flax numpy tree, e.g. from
    :func:`export_jax_variables`) as a DCP checkpoint at ``path``
    (counterpart of ``qiddm_tpu/ckpt.py:407-489``).

    The arrays are copied to host tensors before this returns, so the
    caller may step its optimizer at once. ``async_save=True`` writes them
    in a background (non-daemon) thread and returns; call
    ``wait_until_finished()`` on the handle to join it and surface its
    error. The sidecar ``<path>.meta.json`` is written after the commit."""
    path = pathlib.Path(path).absolute()
    state = {"variables": _host_snapshot(variables)}
    meta = {"loss_values": [float(v) for v in (loss_values or [])],
            "epochs": int(epochs)}
    if not async_save:
        _dcp_commit(path, state, meta)
        return DcpSave()
    handle = DcpSave()

    def run():
        try:
            _dcp_commit(path, state, meta)
        except BaseException as e:  # noqa: BLE001 — re-raised on wait
            handle.error = e

    handle._thread = threading.Thread(target=run, name=f"save {path.name}")
    handle._thread.start()
    return handle


def _placed_like(like, sharding):
    """Empty DTensors shaped as ``like``'s arrays, each on its placement:
    ``sharding`` is one ``parallel.NamedSharding`` for every leaf or a tree
    of them matching ``like``. Each rank allocates only its own rows."""
    from torch.distributed.tensor import DTensor

    from .parallel.mesh import local_rows

    if isinstance(like, Mapping):
        return {k: _placed_like(v, sharding[k] if isinstance(
            sharding, Mapping) else sharding) for k, v in like.items()}
    a = np.asarray(like)
    shape = list(a.shape)
    if sharding.axis is not None:
        rows = local_rows(shape[0], sharding.mesh, sharding.axis)
        shape[0] = rows.stop - rows.start
    local = torch.empty(shape, dtype=torch.from_numpy(a.ravel()[:0]).dtype,
                        device=sharding.mesh.device_type)
    return DTensor.from_local(local, sharding.mesh, sharding.placements(),
                              run_check=False, shape=torch.Size(a.shape),
                              stride=torch.empty(a.shape,
                                                 device="meta").stride())


def load_dcp(path, like, sharding=None) -> Dict[str, Any]:
    """Read a :func:`save_dcp` checkpoint into the structure of ``like``
    (a flax numpy tree giving every array's shape and dtype); returns
    ``{"variables": <numpy tree>, "meta": {"loss_values", "epochs"}}``.

    ``sharding`` (one ``parallel.NamedSharding`` or a matching tree of
    them; the JAX ``load_orbax(sharding=...)``): every rank of its mesh
    calls this, and each array is restored straight onto its placement,
    each rank reading only its own rows; ``variables`` then holds
    DTensors."""
    import json

    path = pathlib.Path(path).absolute()
    if sharding is None:
        state = {"variables": _host_snapshot(like)}
        _dcp().load(state, checkpoint_id=str(path), no_dist=True)
    else:
        state = {"variables": _placed_like(like, sharding)}
        _dcp().load(state, checkpoint_id=str(path))

    def unpack(tree):
        if isinstance(tree, Mapping):
            return {k: unpack(v) for k, v in tree.items()}
        return tree if sharding is not None else tree.numpy()

    meta_file = _meta_path(path)
    meta = (json.loads(meta_file.read_text()) if meta_file.exists()
            else {"loss_values": [], "epochs": 0})
    return {"variables": unpack(state["variables"]), "meta": meta}


def load_dcp_into(net, path, sharding=None) -> Dict[str, Any]:
    """Load a DCP checkpoint into ``net``'s parameters and buffers; returns
    its meta. With ``sharding`` (replicated placements: one net holds no
    shard), every rank of its mesh restores through the process group."""
    out = load_dcp(path, like=export_jax_variables(net), sharding=sharding)
    variables = out["variables"]
    if sharding is not None:
        from torch.distributed.tensor import Replicate

        def local(tree):
            if isinstance(tree, Mapping):
                return {k: local(v) for k, v in tree.items()}
            if not all(isinstance(pl, Replicate) for pl in tree.placements):
                raise ValueError(
                    f"a net holds whole arrays: restore it onto replicated "
                    f"placements, not {tree.placements}")
            return tree.to_local().cpu().numpy()

        variables = local(variables)
    load_jax_variables(net, variables)
    return out["meta"]


def load_variables(net, path, sharding=None) -> Dict[str, Any]:
    """Load one checkpoint into ``net``: a ``.dcp`` directory (the port's
    backend "orbax") or a ``.pt`` file. Returns what it holds beside the
    variables (``loss_values``, ``epochs``). The JAX package's ``.orbax``
    directory (tensorstores) raises ``ValueError`` naming the format.
    ``sharding`` applies to a ``.dcp`` (:func:`load_dcp_into`), as the JAX
    package's applies to orbax only."""
    path = pathlib.Path(path)
    if path.suffix == ".orbax":
        raise ValueError(
            f"{path} is an orbax checkpoint (tensorstores written by the JAX "
            f"package), which qiddm_tpu_torch cannot read: its backend "
            f"'orbax' writes a torch.distributed.checkpoint directory "
            f"(<save_name>_<label>{_DCP_SUFFIX}) instead; pass that or a .pt "
            f"file")
    if path.suffix == _DCP_SUFFIX or path.is_dir():
        return load_dcp_into(net, path, sharding)
    ckpt = load_checkpoint(path)
    load_jax_variables(net, ckpt["model_state_dict"])
    return ckpt


_BACKENDS = ("auto", "pt", "orbax")


def save_diffusion(diff, save_path, label, loss_values, epochs,
                   backend: str = "pt", async_save: bool = False):
    """Driver-level save (reference src/mnist_exm.py:189-201).

    backend "pt": ``<save_path>/<save_name>_<label>.pt`` in the shared
    pickle layout; returns its path. backend "orbax" (the JAX CLI's name):
    the DCP directory ``<save_name>_<label>.dcp``; returns the
    :class:`DcpSave` handle, which with ``async_save=True`` the caller
    joins before the next save and before exit."""
    name = f"{diff.save_name()}_{label}"
    if backend == "orbax":
        return save_dcp(pathlib.Path(save_path) / f"{name}{_DCP_SUFFIX}",
                        export_jax_variables(diff.net),
                        loss_values=loss_values, epochs=epochs,
                        async_save=async_save)
    if backend != "pt":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    sp = pathlib.Path(save_path) / f"{name}.pt"
    return save_checkpoint(sp, export_jax_variables(diff.net),
                           [float(v) for v in loss_values], epochs)


def load_diffusion(diff, load_path, label, backend: str = "auto",
                   sharding=None) -> Tuple[List[float], int]:
    """Driver-level load; returns (loss_values, start_epoch) and keeps the
    fresh model when nothing is found (reference src/mnist_exm.py:294-323).
    ``load_path`` is a directory, a ``.pt`` file or a ``.dcp`` directory.

    backend "auto" prefers ``<save_name>_<label>.dcp``, then the ``.pt``;
    "orbax" reads only the ``.dcp``, "pt" only the ``.pt``. A directory
    holding only the JAX package's ``.orbax`` checkpoint raises
    ``ValueError`` naming that format, which the port cannot read.
    ``sharding`` (a replicated ``parallel.NamedSharding``; ``.dcp`` only,
    as the JAX package's is orbax only) restores through the mesh's
    process group, every rank calling."""
    if backend not in _BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    name = f"{diff.save_name()}_{label}"
    if str(load_path).endswith((_DCP_SUFFIX, ".pt")):
        path = pathlib.Path(load_path)
    else:
        base = pathlib.Path(load_path)
        wanted = [base / f"{name}{suffix}"
                  for suffix, skip in ((_DCP_SUFFIX, "pt"), (".pt", "orbax"))
                  if backend != skip]
        # a lone JAX .orbax goes to load_variables, which refuses it by name
        jax_dir = base / f"{name}.orbax"
        path = next((c for c in wanted if c.exists()),
                    jax_dir if jax_dir.exists() else wanted[-1])
    print(path)
    if not path.exists():
        print("Failed to load model: File not found.\n")
        return [], 0
    meta = load_variables(diff.net, path, sharding)
    print("Model loaded successfully"
          + (" (dcp)" if path.suffix == _DCP_SUFFIX else "") + ".\n")
    return meta.get("loss_values", []), meta.get("epochs", 0)
