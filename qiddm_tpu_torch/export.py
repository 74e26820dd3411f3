"""AOT serving artifacts through ``torch.export`` (counterpart of
``qiddm_tpu/export.py``).

An artifact holds the sampler as an exported program of one denoise
iteration (the net's forward and the goal's update, traced from
``Diffusion._denoise_scan``) and the loop around it: the iterations are
pinned in the header and the loader runs the program that many times, as
the JAX package's artifact runs its ``lax.scan`` body. The batch, the
image and the kernel route are pinned too. It reloads and runs with no
model code and no checkpoint. The port's forward kernels are operators
of the ``qiddm`` namespace (``sim/ops.py``), so the program calls the same
kernels, in the same order, as the live sampler, and their launch counters
count its launches. One iteration is a fifteenth of the graph of 15
unrolled ones, and tracing and serializing grow with the graph.

The trained variables ride inside the artifact but enter the program as
INPUTS, never as baked constants, as in the JAX package
(``qiddm_tpu/export.py:12-21``): the loader passes the stored variables on
every call, and ``load_sampler(blob, variables=tree)`` hot-swaps retrained
weights of the same shapes. The variables are the JAX package's tree
(``ckpt.export_jax_variables``: flax names and layouts, a noisy model's
``noise_cfg/intensity``), stored pickle-free as the JAX package stores them
(an npz and a JSON table of key paths); the header records, for each
leaf, the program input it feeds and its layout (``ckpt._flax_paths``).
So the tree that ``ckpt.load_checkpoint(path)["model_state_dict"]`` returns
hot-swaps into an artifact.

The program segment is ``torch.export``'s JSON graph and the program's
constants (the sign planes and ring tables the sampler reads, small) as an
npz. Loading unpickles nothing, whatever the bytes: ``torch.export.load``
(and ``torch._export.serde``'s ``deserialize`` given bytes) retries a
failed ``torch.load(weights_only=True)`` with ``weights_only=False``, so
this module never hands them a pickle. Before the graph is rebuilt, the
loader refuses any node whose target is not an ``aten`` or ``qiddm``
operator or ``operator.getitem``, any symbolic shape expression and any
guard code, the three places where a crafted graph could reach Python.

``platforms`` names the device the program runs on: ``("cuda",)`` or
``("cpu",)``; by default the model's. A CPU host emits a CUDA artifact by
tracing on the CPU (the operators are device-generic, so the trace holds
the same operator nodes as one on the card) and writing the graph's
devices as the card's. A program whose device this process lacks raises
when it is loaded; it never runs on another device.

Surface:

* :func:`export_sampler` / :func:`load_sampler`: one batch size;
* :func:`export_sampler_bundle` / :func:`load_sampler_bundle` /
  :func:`is_bundle`: a ladder of batch sizes serving any request size;
* CLI: ``python -m qiddm_tpu_torch.cli.sample --export s.qta`` and
  ``--from-export s.qta`` (``cli/sample.py``).

Artifacts are made and loaded by the same PyTorch version: the JSON
graph is ``torch.export``'s, whose schema moves between versions.
"""

from __future__ import annotations

import io
import json
import re
import struct
from collections.abc import Mapping as _Mapping

import numpy as np
import torch

from .ckpt import _NOISE_PATH, _flax_paths, _to_port, export_jax_variables
from .diffusion import stack_to_grid
from .sim import ops as _ops

_ARTIFACT_MAGIC = b"QTA1"
_BUNDLE_MAGIC = b"QTB1"
_PROGRAM_MAGIC = b"QTP1"
# the JAX package's artifacts: StableHLO programs for XLA
_JAX_MAGICS = (b"QSA3", b"QSB3")
# the JAX package's retired formats (a pickle inside, or baked constants)
_RETIRED_MAGICS = (b"QSA2", b"QSB2", b"QSB1")

# the graph's node targets that a loaded program may call
_TARGET = re.compile(r"torch\.ops\.(aten|%s)\.[A-Za-z0-9_]+\.[A-Za-z0-9_]+"
                     % _ops.NAMESPACE)
_GETITEM = "_operator.getitem"
_NOISE_INPUT = "noise_intensity"


def _check_exportable(diff):
    if getattr(diff.net.module, "noise_trajectories", 0):
        raise ValueError(
            "trajectory-noise models sample with a fresh traj_rng per call "
            "and cannot be pinned into a fixed AOT artifact; export the "
            "clean model or use the density-matrix backend")


# --- the variables blob -------------------------------------------------------

def _flatten(tree):
    """[(key path, leaf)] of a tree of str-keyed dicts and lists, dicts in
    sorted key order (``jax.tree_util``'s order, so a blob lists its
    leaves as the JAX package's does)."""
    if isinstance(tree, tuple):
        raise ValueError(
            "variables tree contains a tuple container; AOT artifacts "
            "store str-keyed dicts and lists only (tuples cannot be "
            "reconstructed distinguishably on load)")
    if isinstance(tree, _Mapping):
        out = []
        for k in sorted(tree):
            if not isinstance(k, str):
                raise ValueError(
                    f"variables tree has a non-str dict key {k!r}; AOT "
                    f"artifacts store str-keyed dicts and lists only")
            out += [([["d", k]] + p, v) for p, v in _flatten(tree[k])]
        return out
    if isinstance(tree, list):
        out = []
        for i, node in enumerate(tree):
            out += [([["s", i]] + p, v) for p, v in _flatten(node)]
        return out
    return [([], tree)]


def _var_blob(variables):
    """Encode a variables tree (nested dicts/lists of arrays) WITHOUT
    pickle: a JSON table of tagged key paths and one npz of the leaves,
    snapshotted to host numpy so later training of the live model cannot
    alter the artifact."""
    paths, arrays = [], {}
    for i, (path, leaf) in enumerate(_flatten(variables)):
        paths.append(path)
        if torch.is_tensor(leaf):
            leaf = leaf.detach().cpu().numpy()
        arrays[f"a{i}"] = np.asarray(leaf)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return paths, buf.getvalue()


def _vars_from_blob(paths, vb):
    if len(paths) == 1 and not paths[0]:  # a single bare array
        with np.load(io.BytesIO(vb), allow_pickle=False) as z:
            return z["a0"]
    # every list slot holds at least one leaf, so no legitimate sequence
    # index reaches the leaf count: a crafted index (e.g. 10**9) would
    # otherwise grow the padding list until memory runs out
    max_idx = len(paths)

    def _seq_get(node, key, nxt):
        if not isinstance(key, int) or not 0 <= key < max_idx:
            raise ValueError(
                f"corrupt artifact: sequence index {key!r} out of range")
        while len(node) <= key:
            node.append(None)
        if node[key] is None:
            node[key] = nxt
        return node[key]

    tree = [] if paths and paths[0] and paths[0][0][0] == "s" else {}
    with np.load(io.BytesIO(vb), allow_pickle=False) as z:
        for i, keys in enumerate(paths):
            node = tree
            for (tag, key), (ntag, _) in zip(keys[:-1], keys[1:]):
                nxt = {} if ntag == "d" else []
                if tag == "d":
                    node = node.setdefault(key, nxt)
                else:
                    node = _seq_get(node, key, nxt)
            tag, key = keys[-1]
            if tag == "d":
                node[key] = z[f"a{i}"]
            else:
                _seq_get(node, key, None)
                node[key] = z[f"a{i}"]
    return tree


def _split_var_blob(header, rest):
    """Validate the header's var_len against the payload and split."""
    var_len = header.get("var_len")
    if not isinstance(var_len, int) or not 0 <= var_len <= len(rest):
        raise ValueError(f"corrupt artifact: var_len {var_len!r} outside "
                         f"payload of {len(rest)} bytes")
    return rest[:var_len], rest[var_len:]


def _pack(magic: bytes, header: dict, *blobs: bytes) -> bytes:
    h = json.dumps(header).encode()
    return magic + struct.pack("<I", len(h)) + h + b"".join(blobs)


def _unpack(blob: bytes):
    if len(blob) < 8:
        raise ValueError("corrupt artifact: truncated header")
    hlen = struct.unpack("<I", blob[4:8])[0]
    if 8 + hlen > len(blob):
        raise ValueError(f"corrupt artifact: header length {hlen} exceeds "
                         f"blob of {len(blob)} bytes")
    header = json.loads(blob[8:8 + hlen].decode())
    return header, blob[8 + hlen:]


def _reject_foreign(blob: bytes):
    magic = blob[:4]
    if magic in _RETIRED_MAGICS:
        raise ValueError(
            f"artifact format {magic.decode()} is retired (it embedded a "
            f"pickle / baked constants); re-export with this version")
    if magic in _JAX_MAGICS:
        raise ValueError(
            f"artifact format {magic.decode()} is the JAX package's "
            f"(qiddm_tpu/export.py): StableHLO programs for XLA, which the "
            f"PyTorch port cannot run; export the model with "
            f"qiddm_tpu_torch.export")


# --- the program's inputs -------------------------------------------------------

def _input_table(net, variables):
    """[(program input, layout)] for each leaf of ``variables`` (the JAX
    tree of :func:`ckpt.export_jax_variables`), in the blob's order: a
    parameter or buffer name of ``net.module``, or ``noise_intensity``."""
    by_path = {path: (name, layout)
               for name, (path, layout) in _flax_paths(net).items()}
    by_path[_NOISE_PATH] = (_NOISE_INPUT, None)
    table = []
    for keys, _ in _flatten(variables):
        path = tuple(key for _, key in keys)
        if path not in by_path:
            raise ValueError(f"variable {'/'.join(map(str, path))} feeds no "
                             f"input of {net.save_name()}")
        table.append(list(by_path[path]))
    return table


def _program_inputs(table, paths, variables, device):
    """The program's input tensors on ``device`` from a variables tree laid
    out as the blob's ``paths`` say (port layout, each leaf's own dtype)."""
    leaves = []
    for keys in paths:
        node = variables
        for tag, key in keys:
            try:
                node = node[key]
            except (KeyError, IndexError, TypeError):
                raise ValueError(
                    f"variables have no leaf at "
                    f"{'/'.join(str(k) for _, k in keys)}") from None
        leaves.append(node)
    if len(_flatten(variables)) != len(paths):
        raise ValueError(f"variables hold {len(_flatten(variables))} leaves, "
                         f"the artifact's program takes {len(paths)}")
    out = []
    for (name, layout), leaf in zip(table, leaves):
        if torch.is_tensor(leaf):
            leaf = leaf.detach().cpu().numpy()
        value = np.ascontiguousarray(_to_port(np.asarray(leaf), layout))
        out.append(torch.as_tensor(value, device=device))
    return out


class _Step(torch.nn.Module):
    """One denoise iteration of the sampler as the module that
    ``torch.export`` traces: ``forward(inputs, x) -> next x``, with
    ``inputs`` the variables' tensors as :func:`_input_table` lists them.
    The Diffusion is kept out of the module's attributes, so the net's
    parameters are not lifted into the program: each call swaps the inputs
    in for them (and a noisy model's intensity for its own)."""

    def __init__(self, diff, table, noise_factor: float):
        super().__init__()
        self._run = (diff, table, noise_factor)

    def forward(self, inputs, x):
        diff, table, noise_factor = self._run
        module = diff.net.module
        state = {name: t for (name, _), t in zip(table, inputs)
                 if name != _NOISE_INPUT}
        noise = [t for (name, _), t in zip(table, inputs)
                 if name == _NOISE_INPUT]
        was = getattr(module, "noise_intensity", None)
        try:
            if noise:
                module.noise_intensity = noise[0]
            with torch.nn.utils.stateless._reparametrize_module(module,
                                                                state):
                return diff._denoise_scan(x, 1, noise_factor)[0]
        finally:
            if noise:
                module.noise_intensity = was


def _device_of(diff, platforms) -> torch.device:
    """The program's device: ``platforms`` (one of "cuda", "cpu") or, by
    default, the model's."""
    if platforms is None:
        return diff.net.device
    platforms = tuple(platforms)
    if len(platforms) != 1 or platforms[0] not in ("cuda", "cpu"):
        raise ValueError(
            f"platforms={platforms!r}: a port artifact runs on one device, "
            f"('cuda',) or ('cpu',); TPU programs are the JAX package's "
            f"(qiddm_tpu/export.py)")
    return torch.device(platforms[0])


def _retarget(node, src: str, dst: str):
    """Every device of the JSON graph on ``src`` moved to ``dst``."""
    if isinstance(node, dict):
        if set(node) == {"type", "index"} and node["type"] == src:
            return {"type": dst, "index": 0 if dst == "cuda" else None}
        return {k: _retarget(v, src, dst) for k, v in node.items()}
    if isinstance(node, list):
        return [_retarget(v, src, dst) for v in node]
    return node


def _program_segment(module, args, device: torch.device) -> bytes:
    """Trace ``module(*args)`` with ``torch.export`` and serialize it as a
    program segment for ``device`` (the graph's devices rewritten when it
    is not the inputs'). ``module`` runs once on the real inputs first: the
    device tables the path caches (sign planes, ring rows) are then real
    tensors, which the trace lifts as program constants, and no fake
    tensor of the trace is ever cached. A constant keeps the device it had
    in the trace, the host's or the program's."""
    from torch._export.serde import serialize as serde

    here = args[-1].device
    with torch.no_grad():
        module(*args)
        ep = torch.export.export(module, tuple(args), strict=False)
    if ep.state_dict:
        raise ValueError(f"the trace lifted parameters "
                         f"{sorted(ep.state_dict)}; they must be inputs")
    graph = json.loads(serde.serialize(ep).exported_program)
    for node in graph["graph_module"]["graph"]["nodes"]:
        node["metadata"] = {}  # stack traces: the export host's paths
    if device.type != here.type:
        graph = _retarget(graph, here.type, device.type)
    names = sorted(ep.constants)
    consts, on_host = {}, []
    for i, name in enumerate(names):
        value = ep.constants[name]
        if not torch.is_tensor(value):
            raise ValueError(f"program constant {name} is a "
                             f"{type(value).__name__}, not a tensor")
        consts[f"c{i}"] = value.detach().cpu().numpy()
        on_host.append(value.device.type != here.type)
    buf = io.BytesIO()
    np.savez(buf, **consts)
    g = json.dumps(graph).encode()
    return _pack(_PROGRAM_MAGIC,
                 {"graph_len": len(g), "constants": names,
                  "on_host": on_host, "device": device.type},
                 g, buf.getvalue())


def _export_program(diff, table, inputs, *, batch: int, noise_factor: float,
                    device: torch.device) -> bytes:
    """One denoise iteration of ``diff``'s sampler at ``batch``."""
    x = torch.rand((batch, 1, diff.width, diff.height),
                   device=diff.net.device)
    return _program_segment(_Step(diff, table, noise_factor), (inputs, x),
                            device)


def _check_graph(graph: dict) -> None:
    """Refuse a JSON graph that could reach Python beyond the operators:
    a node target other than an ``aten`` or ``qiddm`` operator or
    ``operator.getitem``, a subgraph, a symbolic shape expression (parsed
    with ``sympy.sympify``, which evaluates) or guard code (compiled into
    the loaded module)."""
    gm = graph.get("graph_module", {})
    for node in gm.get("graph", {}).get("nodes", []):
        target = node.get("target")
        if not isinstance(target, str) or not (
                target == _GETITEM or _TARGET.fullmatch(target)):
            raise ValueError(f"corrupt artifact: the program calls "
                             f"{target!r}, not a tensor operator")
    if graph.get("guards_code") or graph.get("range_constraints"):
        raise ValueError("corrupt artifact: the program carries guard code "
                         "or symbolic shapes")

    def walk(node):
        if isinstance(node, dict):
            for key, value in node.items():
                if key in ("as_expr", "expr_str", "as_graph",
                           "as_custom_obj"):
                    raise ValueError(f"corrupt artifact: the program holds "
                                     f"a {key} entry")
                walk(value)
        elif isinstance(node, list):
            for value in node:
                walk(value)

    walk(graph)


def _check_device(device: torch.device) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the artifact's program runs on cuda and this process has no "
            "CUDA device; it never runs on another device")


def _read_program(segment: bytes, device=None):
    """An ``ExportedProgram`` from a program segment, its constants on
    ``device`` (the program's own device by default). Nothing in it is
    unpickled: the graph is JSON, checked by :func:`_check_graph` before it
    is rebuilt, and the constants an npz read with ``allow_pickle=False``.
    Returns (program, its device)."""
    from torch._export.serde import serialize as serde

    if segment[:4] != _PROGRAM_MAGIC:
        raise ValueError("corrupt artifact: no program segment")
    header, rest = _unpack(segment)
    glen = header.get("graph_len")
    names = header.get("constants")
    on_host = header.get("on_host")
    if (not isinstance(glen, int) or not 0 <= glen <= len(rest)
            or not isinstance(names, list) or not isinstance(on_host, list)
            or len(on_host) != len(names)):
        raise ValueError("corrupt artifact: bad program header")
    graph_bytes = rest[:glen]
    graph = json.loads(graph_bytes)
    _check_graph(graph)
    target = torch.device(header.get("device", "cpu"))
    where = target if device is None else torch.device(device)
    try:
        with np.load(io.BytesIO(rest[glen:]), allow_pickle=False) as z:
            arrays = [z[f"c{i}"] for i in range(len(names))]
    except Exception as e:  # a pickle, or not our npz
        raise ValueError(f"corrupt artifact: the program's constants do "
                         f"not read as a plain npz ({e})") from None
    consts = {name: torch.as_tensor(a).to("cpu" if host else where)
              for name, a, host in zip(names, arrays, on_host)}
    ep = serde.deserialize(serde.SerializedArtifact(graph_bytes, {}, consts,
                                                    b""))
    return ep, target


def _bind(segment: bytes, inputs, n_iters: int, only_last: bool = True):
    """``(call, device, x_shape, out)``: the program of ``segment``, one
    denoise iteration, as a callable ``first_x -> images`` that runs it
    ``n_iters`` times on its device with ``inputs`` (the variables'
    tensors); the device, the first_x shape it takes, and its output's
    (shape, dtype). ``only_last=False`` returns the reference's grid of
    the start and every iteration. The graph module is called on its flat
    inputs (constants, then the variables and x), as the graph takes
    them."""
    from torch.export.graph_signature import InputKind, OutputKind

    ep, target = _read_program(segment)
    sig = ep.graph_signature
    if (any(s.kind not in (InputKind.USER_INPUT, InputKind.CONSTANT_TENSOR)
            for s in sig.input_specs)
            or [s.kind for s in sig.output_specs] != [OutputKind.USER_OUTPUT]):
        raise ValueError("corrupt artifact: the program takes parameters or "
                         "mutates its inputs")
    users = [i for i, s in enumerate(sig.input_specs)
             if s.kind == InputKind.USER_INPUT]
    if len(users) != len(inputs) + 1:
        raise ValueError(f"the artifact's program takes {len(users) - 1} "
                         f"variables, {len(inputs)} given")
    args = [None if s.kind == InputKind.USER_INPUT else ep.constants[s.target]
            for s in sig.input_specs]
    for i, t in zip(users, inputs):
        args[i] = t
    x_spec = next(n for n in ep.graph.nodes if n.op == "placeholder"
                  and n.name == sig.input_specs[users[-1]].arg.name)
    x_shape = tuple(x_spec.meta["val"].shape)
    out_val = next(n for n in ep.graph.nodes
                   if n.op == "output").args[0][0].meta["val"]
    step = ep.graph_module

    def call(first_x):
        if not torch.is_tensor(first_x) or first_x.device.type != target.type:
            raise ValueError(f"the artifact's program runs on {target}; "
                             f"got first_x on "
                             f"{getattr(first_x, 'device', type(first_x))}")
        if tuple(first_x.shape) != x_shape:
            raise ValueError(f"the artifact's program takes first_x of "
                             f"shape {x_shape}, got {tuple(first_x.shape)}")
        x, xs = first_x, [first_x]
        with torch.no_grad():
            for _ in range(n_iters):
                args[users[-1]] = x
                x = step(*args)[0]
                xs.append(x)
        args[users[-1]] = None
        return x if only_last else stack_to_grid(torch.stack(xs))

    return call, target, x_shape, (tuple(out_val.shape), out_val.dtype)


def _variables_of(diff):
    variables = export_jax_variables(diff.net)
    return variables, _input_table(diff.net, variables)


def export_sampler(diff, *, batch: int, n_iters: int,
                   only_last: bool = True, noise_factor: float = 1.0,
                   platforms=None) -> bytes:
    """Serialize ``diff``'s sampler as a self-contained AOT artifact.

    ``batch``, ``n_iters``, the image shape and the kernel route are pinned
    into the program (use :func:`export_sampler_bundle` for a ladder of
    batch sizes). ``only_last=True`` emits ``(batch, 1, h, w)`` final
    images; ``False`` the reference's stacked grid. ``platforms``:
    ``("cuda",)`` to emit a CUDA artifact from a CPU host; by default the
    model's device.

    Trajectory-noise models need a ``traj_rng`` each call and are not
    exportable as a fixed program; they raise.
    """
    _check_exportable(diff)
    device = _device_of(diff, platforms)
    variables, table = _variables_of(diff)
    paths, vb = _var_blob(variables)
    inputs = _program_inputs(table, paths, variables, diff.net.device)
    prog = _export_program(diff, table, inputs, batch=batch,
                           noise_factor=noise_factor, device=device)
    return _pack(_ARTIFACT_MAGIC,
                 {"var_len": len(vb), "var_paths": paths, "inputs": table,
                  "device": device.type, "n_iters": int(n_iters),
                  "only_last": bool(only_last)}, vb, prog)


def _loop_of(header) -> tuple[int, torch.device]:
    """The iterations and the device an artifact's header pins."""
    n_iters = header.get("n_iters")
    if not isinstance(n_iters, int) or n_iters < 0:
        raise ValueError(f"corrupt artifact: n_iters {n_iters!r}")
    return n_iters, torch.device(header.get("device", "cpu"))


def _stored_inputs(header, vb, variables, device):
    """The program's inputs on ``device``: the artifact's own variables,
    or the hot-swapped ``variables`` tree laid out as the header's
    paths."""
    paths, table = header["var_paths"], header.get("inputs")
    if not isinstance(table, list) or len(table) != len(paths):
        raise ValueError("corrupt artifact: the input table does not match "
                         "the variables' paths")
    tree = _vars_from_blob(paths, vb) if variables is None else variables
    return _program_inputs(table, paths, tree, device)


def load_sampler(blob: bytes, variables=None):
    """Deserialize an exported sampler into a callable ``first_x -> out``.

    The callable runs the embedded program on its device (``first_x`` must
    lie there and have the exported shape): no model code or checkpoint
    needed, the artifact carries the variables pickle-free. Pass
    ``variables`` (the JAX package's tree, as ``ckpt.load_checkpoint(...)
    ["model_state_dict"]`` gives it) to hot-swap retrained weights of the
    same shapes into the program.
    """
    _reject_foreign(blob)
    if is_bundle(blob):
        raise ValueError("this is a bucketed bundle artifact; use "
                         "load_sampler_bundle")
    if blob[:4] != _ARTIFACT_MAGIC:
        raise ValueError("not a sampler artifact (missing QTA magic)")
    header, rest = _unpack(blob)
    vb, prog = _split_var_blob(header, rest)
    n_iters, device = _loop_of(header)
    _check_device(device)
    inputs = _stored_inputs(header, vb, variables, device)
    return _bind(prog, inputs, n_iters, bool(header.get("only_last", True)))[0]


# --- bucketed bundles (multi-batch-size serving) -----------------------------

def export_sampler_bundle(diff, *, batches, n_iters: int,
                          noise_factor: float = 1.0,
                          platforms=None) -> bytes:
    """Export one program per batch size into a single bundle.

    A program has static shapes, so serving buckets requests by size;
    this emits the bucket ladder (e.g. ``batches=[1, 8, 64]``) as one
    file, the variables stored ONCE and shared by every bucket's program.
    :func:`load_sampler_bundle` serves ANY request size from it: the
    smallest bucket that fits, with row padding (per-image denoising is
    batch-independent, so padded rows cannot perturb real ones), chunked
    through the largest bucket for oversized requests. ``only_last`` is
    pinned True: grid mode concatenates images across the batch axis and
    cannot be row-sliced back.
    """
    _check_exportable(diff)
    batches = sorted(set(int(b) for b in batches))
    if not batches or batches[0] < 1:
        raise ValueError(f"need positive batch sizes, got {batches!r}")
    device = _device_of(diff, platforms)
    variables, table = _variables_of(diff)
    paths, vb = _var_blob(variables)
    inputs = _program_inputs(table, paths, variables, diff.net.device)
    progs = [_export_program(diff, table, inputs, batch=b,
                             noise_factor=noise_factor, device=device)
             for b in batches]
    return _pack(_BUNDLE_MAGIC,
                 {"batches": batches, "var_len": len(vb),
                  "var_paths": paths, "inputs": table,
                  "device": device.type, "n_iters": int(n_iters),
                  "lengths": [len(p) for p in progs]}, vb, *progs)


def is_bundle(blob: bytes) -> bool:
    return blob[:4] == _BUNDLE_MAGIC


def artifact_device(blob: bytes) -> torch.device:
    """The device an artifact's program runs on, from its header."""
    _reject_foreign(blob)
    if blob[:4] not in (_ARTIFACT_MAGIC, _BUNDLE_MAGIC):
        raise ValueError("not a sampler artifact (missing QTA/QTB magic)")
    return torch.device(_unpack(blob)[0].get("device", "cpu"))


def load_sampler_bundle(blob: bytes, variables=None):
    """Deserialize a bundle into a callable serving ANY ``(n, 1, h, w)``.

    Picks the smallest bucket >= n (padding the tail rows); requests
    larger than the biggest bucket run in chunks of it; n == 0 returns an
    empty batch of the programs' output shape and dtype without running a
    program. ``variables`` hot-swaps retrained weights (same shapes) into
    every bucket.
    """
    _reject_foreign(blob)
    if not is_bundle(blob):
        raise ValueError("not a sampler bundle (missing QTB magic); "
                         "use load_sampler for single-batch artifacts")
    header, rest = _unpack(blob)
    batches, lengths = header["batches"], header["lengths"]
    vb, progs = _split_var_blob(header, rest)
    if len(batches) != len(lengths) or sum(lengths) != len(progs):
        raise ValueError("corrupt artifact: the bucket lengths do not match "
                         "the payload")
    n_iters, device = _loop_of(header)
    _check_device(device)
    inputs = _stored_inputs(header, vb, variables, device)
    off, fns = 0, {}
    x_tail = out_tail = out_dtype = None
    for b, ln in zip(batches, lengths):
        fns[b], _, x_shape, (out_shape, dtype) = _bind(
            progs[off:off + ln], inputs, n_iters)
        if x_tail is None:
            # recorded so that n == 0 keeps the shape and dtype contract
            # of every n > 0 request
            x_tail, out_tail, out_dtype = (x_shape[1:], out_shape[1:],
                                           dtype)
        off += ln

    def _run_bucket(x):
        n = x.shape[0]
        if n == 0:
            if tuple(x.shape[1:]) != x_tail:
                raise ValueError(f"bundle expects inputs of shape "
                                 f"(n, {', '.join(map(str, x_tail))}); "
                                 f"got {tuple(x.shape)}")
            return torch.zeros((0,) + out_tail, dtype=out_dtype,
                               device=device)
        bucket = next((b for b in batches if b >= n), None)
        if bucket is None:
            big = batches[-1]
            return torch.cat([_run_bucket(x[i:i + big])
                              for i in range(0, n, big)])
        if n < bucket:
            pad = x[-1:].expand((bucket - n,) + tuple(x.shape[1:]))
            return fns[bucket](torch.cat([x, pad]))[:n]
        return fns[bucket](x)

    return _run_bucket
