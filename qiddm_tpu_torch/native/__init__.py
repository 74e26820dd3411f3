"""qiddm_tpu_torch.native — the framework's own C++ simulation engine
(counterpart of the JAX package's ``native``).

Bindings (ctypes) to this package's copy of ``qsim.cpp``: a statevector /
density-matrix gate-stream interpreter in float64 playing the role the
external C++ engines play in the reference (PennyLane-Lightning,
qiskit-aer). It runs on the host, not on the card, and is built with g++ at
first use into ``build/qiddm_tpu_torch/``; see ``available()``.
"""

from . import qsim  # noqa: F401
from .qsim import (  # noqa: F401
    Op,
    adjoint_grad,
    available,
    build_reupload_ops,
    build_sel_ops,
    density_run,
    sample_counts,
    statevector_run,
)
