"""qiddm_tpu_torch.nn — the ported denoisers behind the reference's public
names (counterpart of ``qiddm_tpu/nn``)."""

from .core import Reupload as ReuploadModule  # noqa: F401
from .qdense import QIDDM_LL_noise  # noqa: F401
from .shim import DenoiserShim  # noqa: F401
