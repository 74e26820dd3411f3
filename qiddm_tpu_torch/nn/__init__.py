"""qiddm_tpu_torch.nn — the ported denoisers behind the reference's public
names (counterpart of ``qiddm_tpu/nn``)."""

from .conv import (  # noqa: F401
    DeepConvDirectedMulti,
    DeepConvDirectedSingle,
    DeepConvUndirected,
)
from .core import Reupload as ReuploadModule  # noqa: F401
from .qdense import (  # noqa: F401
    QIDDM_A_differN_NEW,
    QIDDM_A_differN_basePL,
    QIDDM_A_sameN,
    QIDDM_CL_new,
    QIDDM_CL_old,
    QIDDM_L,
    QIDDM_L_B,
    QIDDM_LL_noise,
    QIDDM_LL_old,
    QIDDM_LL_relu_noise,
    QIDDM_PP_noise,
    QIDDM_PP_old,
    QIDDM_bias_false,
    QIDDM_PL,
    QIDDM_PL_noise,
    QIDDM_PL_noise1,
    QIDDM_PL_old,
    QNN,
    QNN_A,
    QNN_noise,
    QDenseUndirected_old,
    QDenseUndirected_old_noise,
    differN_new_conv,
    differN_new_pca,
    differN_noise,
    differN_noise_befor,
    differN_old_conv,
    differN_old_pca,
)
from .qconv import QConv2d, QConv2dMedium, QConv2dSlow  # noqa: F401
from .shim import DenoiserShim  # noqa: F401
from .unet import (  # noqa: F401
    UNetUndirected,
    UNetUndirectedS,
    UnetDirected,
    UnetDirectedS,
)
