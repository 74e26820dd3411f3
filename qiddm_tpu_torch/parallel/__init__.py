"""qiddm_tpu_torch.parallel — device meshes on torch.distributed
(counterpart of ``qiddm_tpu/parallel/``).

The scaling axes, as in the JAX package:

* data parallel: the tau-expanded image batch split over a ``data`` mesh
  dim, gradients summed over it (``Diffusion.make_multi_epoch_fn``);
  sampling splits the image batch and all-gathers it;
* trial parallel: a sweep's trials split over a ``trial`` mesh dim
  (``sweep.sweep_lr``);
* the statevector itself split over a mesh dim (``sim/sharded.py``).

One process a device (SPMD); see :mod:`.mesh` and :mod:`.distributed`.
"""

from .distributed import initialize as initialize_distributed  # noqa: F401
from .mesh import (  # noqa: F401
    NamedSharding,
    dp_constraint,
    make_mesh,
    replicate,
    shard_leading_axis,
)
