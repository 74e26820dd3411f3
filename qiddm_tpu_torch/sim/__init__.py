"""qiddm_tpu_torch.sim — batched statevector simulation in PyTorch, with the
re-uploading gate chains (``gate_kernel``: RZ encode; ``ry_kernel``: RY
encode) and the SEL chain (``sel_kernel``), each with its adjoint backward,
the density-matrix block (``dm_kernel``) and the amplitude-damping
trajectory pass (``amp_damp_kernel``), the wide (11-20 wire) chain's
grouped sublayer (``wide_kernel``, with ``wide``) and the chain that streams
dense layer unitaries (``unitary_kernel``, CNOT-ring re-upload blocks up to
8 wires) as hand-written CUDA kernels, and the Monte-Carlo trajectory noise
backend (``trajectories``). Past the kernels' widths and in complex128 the
routes the JAX package runs in XLA are plain PyTorch: the grouped chain
(``wide``), the per-gate adjoint chain (``wide`` with one-wire groups) and
``sel_apply_gates`` (``sel``); ``ROUTE_CALLS`` counts their calls. The
submodules ``gradients`` (parameter-shift gradients through
``torch.func.vmap``) and ``qasm`` (the QASM bridge: OPENQASM text, a
complex128 statevector run on the card, shots drawn by the native engine)
are the JAX package's ``sim/gradients.py`` and ``sim/qasm.py``."""

from .amp_damp_kernel import amp_damp, amp_damp_plain  # noqa: F401
from .engine import qdense_circuit, qnn_circuit, reupload_block  # noqa: F401
from .gate_kernel import (  # noqa: F401
    gate_chain_bwd_plain,
    gate_chain_planes,
    gate_chain_planes_plain,
)
from .gates import (  # noqa: F401
    WEIGHT_MAPS,
    plain_tanh,
    qw_tanh,
    rot_matrix,
    ry_matrix,
)
from .ry_kernel import (  # noqa: F401
    ry_chain,
    ry_chain_bwd_plain,
    ry_chain_planes,
    ry_chain_planes_plain,
)
# ROUTE_CALLS is a dict updated in place: this name stays current
from .sel import (  # noqa: F401
    ROUTE_CALLS,
    cnot_ring_perm,
    cz_ring_signs,
    sel_layer_unitaries,
    reset_route_calls,
    sel_apply_gates,
    sel_ranges,
    sel_unitaries,
    sel_unitary,
)
from .sel_kernel import (  # noqa: F401
    sel_chain_bwd_plain,
    sel_chain_planes,
    sel_chain_planes_plain,
    sel_chain_rows,
    sel_chain_rows_plain,
)
from .statevector import (  # noqa: F401
    amplitude_embed,
    apply_1q,
    apply_ry_all,
    apply_unitary,
    bit_table,
    expval_z,
    expval_z_from_planes,
    probs,
    probs_from_planes,
    ry_gates,
    ry_product_state,
    rz_phase_planes,
    rz_phases,
    z_sign_table,
    zero_state,
)
from .trajectories import (  # noqa: F401
    RecordedDraws,
    ReplayDraws,
    TrajDraws,
    apply_channel_trajectory,
    qdense_circuit_trajectories,
    qnn_circuit_trajectories,
    reupload_block_trajectories,
    wire_one_prob,
)
# the launch counters are read from the module, unitary_kernel.
# UNITARY_LAUNCHES and unitary_kernel.UNITARY_BWD_LAUNCHES
from .unitary_kernel import (  # noqa: F401
    unitary_chain_bwd_plain,
    unitary_chain_planes,
    unitary_chain_planes_plain,
)
from .wide import (  # noqa: F401
    group_gates,
    group_sizes,
    max_group_bits,
    reupload_chain_wide,
    sel_chain_wide,
)
# the launch counters are read from the module, wide_kernel.WIDE_LAUNCHES
# and wide_kernel.WIDE_BWD_LAUNCHES: a name imported here would keep the
# value it had at import
from .wide_kernel import (  # noqa: F401
    wide_chain_bwd_plain,
    wide_chain_planes,
    wide_chain_planes_plain,
)
# registers the forward kernels' operators (qiddm::*), which the kernel
# modules' autograd Functions call
from . import ops  # noqa: E402,F401
from . import gradients, qasm  # noqa: E402,F401
