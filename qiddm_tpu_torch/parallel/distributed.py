"""Multi-process initialization and data plumbing on ``torch.distributed``
(counterpart of ``qiddm_tpu/parallel/distributed.py``).

The JAX package joins hosts with ``jax.distributed`` and feeds per-host
data into one global array. Here every rank is a process: each calls
:func:`initialize` (or lets ``parallel.make_mesh`` call it), builds the
same mesh, and reads its own slice of the data (:func:`host_local_batch`);
a result that every rank needs in full comes back through an all-gather
that every rank enters (:func:`to_host`).

``torchrun --nproc-per-node N`` sets the environment read here:
``MASTER_ADDR``/``MASTER_PORT`` (the JAX package's
``JAX_COORDINATOR_ADDRESS``), ``WORLD_SIZE`` (``JAX_NUM_PROCESSES``) and
``RANK`` (``JAX_PROCESS_ID``), and ``LOCAL_RANK`` picks the card.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import _tree_map, backend_for, make_mesh, placements


def _env_coordinator() -> Optional[str]:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device="cuda") -> bool:
    """Form the default process group from the arguments or ``torchrun``'s
    environment (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``).

    Returns True when a group exists afterwards, False when nothing
    configures one (one process: callers treat False as "single host").
    A topology with no coordinator address raises ``ValueError``: this
    process would run alone while its peers wait for it. On the card each
    rank takes the GPU ``LOCAL_RANK`` names."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or _env_coordinator()
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError(
                f"num_processes={num_processes}/process_id={process_id} "
                f"given but no coordinator address (arg or "
                f"MASTER_ADDR/MASTER_PORT): this process would silently "
                f"run single-process while its peers wait for it")
        return False
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    device_type = torch.device(device).type
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % max(torch.cuda.device_count(), 1))))
    dist.init_process_group(backend_for(device_type),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    return True


def shutdown() -> None:
    """Destroy the default process group, if there is one: later code sees
    ``dist.is_initialized()`` False again."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    """This process's rank, 0 without a group (``jax.process_index``)."""
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(axis_names: Tuple[str, ...] = ("data",),
                axis_sizes: Optional[Sequence[int]] = None, *,
                device="cuda"):
    """A mesh over every rank of the group, rank-major: a 1-D ``("data",)``
    mesh gives rank r the r-th slab of a batch (:func:`host_local_batch`)."""
    return make_mesh(None, axis_names, axis_sizes, device=device)


def host_local_batch(local_data, mesh, axis_name: str = "data"):
    """The global batch-sharded DTensor made of each rank's own rows (the
    multi-host data path: no rank holds the global batch). ``local_data``
    is this rank's (local_batch, ...) array; the global leading dim is
    ``local_batch`` times the ranks of ``axis_name``."""
    from torch.distributed.tensor import DTensor

    local = torch.as_tensor(np.asarray(local_data)).to(mesh.device_type)
    return DTensor.from_local(local, mesh, placements(mesh, axis_name),
                              run_check=False)


def replicate_from_host(tree, mesh):
    """Every array of ``tree`` (equal on every rank) as a DTensor
    replicated over the mesh, with no communication."""
    from torch.distributed.tensor import DTensor

    def put(a):
        t = torch.as_tensor(np.asarray(a)).to(mesh.device_type)
        return DTensor.from_local(t, mesh, placements(mesh), run_check=False)

    return _tree_map(put, tree)


def to_host(a) -> np.ndarray:
    """numpy of a possibly sharded array: a DTensor is all-gathered (every
    rank of its mesh must call this), a tensor copied to the host."""
    from torch.distributed.tensor import DTensor

    if isinstance(a, DTensor):
        a = a.full_tensor()
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)
