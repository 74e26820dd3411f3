"""Device meshes on ``torch.distributed`` (counterpart of
``qiddm_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process builds a ``Mesh`` over
``jax.devices()[:n]`` and XLA's SPMD partitioner inserts the collectives.
The port is SPMD: one process a device, launched by ``torchrun`` (or, in
the tests, ``torch.multiprocessing.spawn``), and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dims carry the JAX axis
names (``"data"``, ``"trial"``). CUDA tensors go through NCCL, CPU tensors
through gloo: a group made here has the backend ``"cpu:gloo,cuda:nccl"``
on the card and ``"gloo"`` on the CPU. NCCL takes one rank a GPU, so one
card holds a one-rank mesh.

A sharded array is a DTensor with ``Shard(0)`` on the named dim and
``Replicate()`` on the others; rows split as ``torch.chunk`` splits them
(:func:`local_rows`), which is how DTensor's ``Shard(0)`` splits them too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# Collectives the mesh code issued since the last reset: "p2p" (a pairwise
# exchange, sim/sharded.py), "all_reduce", "all_gather". chip_smoke.py reads
# them beside the kernels' launch counts.
COLLECTIVES = {"p2p": 0, "all_reduce": 0, "all_gather": 0}


def reset_collectives() -> None:
    for key in COLLECTIVES:
        COLLECTIVES[key] = 0


def backend_for(device_type: str) -> str:
    """The process group's backend: NCCL for CUDA tensors (gloo beside it
    for the CPU tensors of checkpoint and object collectives), gloo on the
    CPU."""
    return "cpu:gloo,cuda:nccl" if device_type == "cuda" else "gloo"


def _device_type(device) -> str:
    from ..config import resolve_device

    return resolve_device(device).type


def _one_rank_group(device_type: str) -> None:
    """A process group of this process alone, on an in-memory store: the
    one-device mesh needs no launcher and no port."""
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend_for(device_type), store=dist.HashStore(),
                            rank=0, world_size=1)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("data",),
              axis_sizes: Optional[Sequence[int]] = None, *,
              device="cuda"):
    """A mesh over ``n_devices`` ranks, one device each.

    With one axis the mesh is 1-D over all ranks; with several,
    ``axis_sizes`` gives the grid (its product is the rank count). Without
    a process group, one is formed from ``torchrun``'s environment
    (:func:`distributed.initialize`), or, when there is none, a one-rank
    group of this process. Asking for more devices than there are ranks
    raises ``ValueError`` before any group is formed. ``device`` "cuda"
    raises without a card, as every entry point of the port does."""
    from .distributed import initialize

    device_type = _device_type(device)
    if not dist.is_initialized():
        initialize(device=device_type)
    available = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices > available:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only {available} "
            f"device(s) are available (one device a rank: launch "
            f"{n_devices} ranks with torchrun --nproc-per-node {n_devices})")
    n = available if n_devices is None else int(n_devices)
    if n != available:
        raise ValueError(f"a {n}-device mesh in a group of {available} "
                         f"ranks: a mesh spans every rank of the group")
    if not dist.is_initialized():
        _one_rank_group(device_type)
    if axis_sizes is None:
        axis_sizes = [n] + [1] * (len(axis_names) - 1)
    if math.prod(axis_sizes) != n or len(axis_sizes) != len(axis_names):
        raise ValueError(f"axis sizes {tuple(axis_sizes)} for axes "
                         f"{tuple(axis_names)} do not tile {n} device(s)")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(int(s) for s in axis_sizes),
                            mesh_dim_names=tuple(axis_names))


def has_axis(mesh, axis: str) -> bool:
    return mesh is not None and axis in (mesh.mesh_dim_names or ())


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def placements(mesh, axis: Optional[str] = None) -> list:
    """DTensor placements: ``Shard(0)`` on ``axis``, ``Replicate()`` on
    every other dim (all of them with ``axis`` None)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def split_rows(n: int, size: int, rank: int) -> slice:
    """Rank ``rank``'s rows of ``n`` split over ``size`` ranks as
    ``torch.chunk`` (and DTensor's ``Shard(0)``) splits them: ceil(n /
    size) a rank, the last ranks short or empty."""
    per = -(-n // size)
    start = min(rank * per, n)
    return slice(start, min(start + per, n))


def local_rows(n: int, mesh, axis: str = "data") -> slice:
    """This rank's rows of ``n`` split over ``axis`` (:func:`split_rows`)."""
    return split_rows(n, axis_size(mesh, axis), mesh.get_local_rank(axis))


def all_reduce_(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum ``t`` in place over ``axis``."""
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(t, group=mesh.get_group(axis))
    return t


def gather_rows(t: torch.Tensor, n: int, mesh, axis: str = "data",
                dim: int = 0) -> torch.Tensor:
    """The ``n`` rows of a tensor split over ``axis`` by
    :func:`local_rows`, along ``dim``, on every rank of ``axis`` (one
    all-gather; a short rank pads with zeros, which are cut off)."""
    size = axis_size(mesh, axis)
    per = -(-n // size)
    local = t.movedim(dim, 0)
    if local.shape[0] < per:
        pad = local.new_zeros((per - local.shape[0],) + local.shape[1:])
        local = torch.cat([local, pad])
    local = local.contiguous()
    out = local.new_empty((size * per,) + local.shape[1:])
    COLLECTIVES["all_gather"] += 1
    dist.all_gather_into_tensor(out, local, group=mesh.get_group(axis))
    return out[:n].movedim(0, dim)


@dataclass(frozen=True)
class NamedSharding:
    """A placement on a mesh (``jax.sharding.NamedSharding(mesh,
    P(axis))``): the leading axis sharded over the mesh dim ``axis``, or
    every dim replicated with ``axis`` None."""

    mesh: object
    axis: Optional[str] = None

    def placements(self) -> list:
        return placements(self.mesh, self.axis)


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _as_tensor(a, mesh) -> torch.Tensor:
    if not torch.is_tensor(a):
        a = torch.as_tensor(np.asarray(a))
    return a.to(mesh.device_type)


def shard_leading_axis(mesh, tree, axis_name: str = "data"):
    """Every array of ``tree`` as a DTensor with its leading axis sharded
    over ``axis_name`` (each rank passes the same values; each keeps its
    rows)."""
    from torch.distributed.tensor import distribute_tensor

    return _tree_map(lambda a: distribute_tensor(
        _as_tensor(a, mesh), mesh, placements(mesh, axis_name)), tree)


def replicate(mesh, tree):
    """Every array of ``tree`` as a DTensor replicated over the mesh."""
    from torch.distributed.tensor import distribute_tensor

    return _tree_map(lambda a: distribute_tensor(
        _as_tensor(a, mesh), mesh, placements(mesh)), tree)


def dp_constraint(x, mesh, axis_name: str = "data"):
    """This rank's rows of the batch ``x`` over ``axis_name``; ``x`` itself
    without a mesh (one device)."""
    if mesh is None:
        return x
    return x[local_rows(x.shape[0], mesh, axis_name)]
