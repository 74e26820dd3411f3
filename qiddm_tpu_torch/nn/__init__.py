"""qiddm_tpu_torch.nn — the ported denoisers behind the reference's public
names (counterpart of ``qiddm_tpu/nn``)."""

from .core import Reupload as ReuploadModule  # noqa: F401
from .qdense import (  # noqa: F401
    QIDDM_LL_noise,
    QIDDM_PL,
    QIDDM_PL_noise,
    QIDDM_PL_noise1,
    QIDDM_PL_old,
    QNN,
    QNN_A,
    QNN_noise,
    QDenseUndirected_old,
    QDenseUndirected_old_noise,
    differN_noise,
    differN_noise_befor,
)
from .shim import DenoiserShim  # noqa: F401
