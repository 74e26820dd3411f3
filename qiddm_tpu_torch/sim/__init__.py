"""qiddm_tpu_torch.sim — batched statevector simulation in PyTorch, with the
re-uploading gate chain and its adjoint backward as hand-written CUDA
kernels (``gate_kernel``)."""

from .engine import reupload_block  # noqa: F401
from .gate_kernel import (  # noqa: F401
    gate_chain_bwd_plain,
    gate_chain_planes,
    gate_chain_planes_plain,
)
from .gates import rot_matrix  # noqa: F401
from .sel import cz_ring_signs, sel_ranges, sel_unitaries  # noqa: F401
from .statevector import (  # noqa: F401
    apply_unitary,
    bit_table,
    expval_z,
    expval_z_from_planes,
    probs,
    probs_from_planes,
    rz_phase_planes,
    rz_phases,
    z_sign_table,
    zero_state,
)
