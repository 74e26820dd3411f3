"""The reference's dense quantum models by public name (counterpart of
``qiddm_tpu/nn/qdense.py``): all 28 classes, with the JAX package's
constructor signatures, byte-identical ``save_name()`` strings and
attributes. The Qdense baseline, ``QNN_A``, the QNN pair, and the
re-uploading families on ``core.Reupload``: differN (QIDDM-A: PCA, conv or
no down-projection, probabilities readout), QIDDM-L (PauliZ readout
between linear, PCA or conv down and linear or inverse-PCA up), with
their shared-weight, per-block, BatchNorm and bias-free options, each
noisy class with every ``add_noise`` code the reference knows (0-4).

A model with a lazily fitted PCA (``QIDDM_PP_old``) fits it on
``init_batch`` (real training images, (b, 1, w, h)) when the caller
passes one, as the drivers do; otherwise on 32 uniform images drawn from
a CPU generator seeded ``seed + 1``, where the JAX package draws from
``PRNGKey(seed + 1)``: the same rule, other draws.
"""

from __future__ import annotations

import ast
import math
import operator as _op

import numpy as np
import torch

from .core import QDense as _QDenseModule
from .core import QNNA as _QNNAModule
from .core import QNNDense as _QNNDenseModule
from .core import Reupload as _ReuploadModule
from .shim import DenoiserShim, _square_or_flat

_ALLOWED_OPS = {
    ast.Add: _op.add, ast.Sub: _op.sub, ast.Mult: _op.mul,
    ast.FloorDiv: _op.floordiv, ast.Pow: _op.pow,
}


def _int_arg(v) -> int:
    """Parse int args that may arrive as arithmetic strings like "28 * 28"
    (the reference evals these; parsed safely here)."""
    if isinstance(v, int):
        return v
    if isinstance(v, str):
        node = ast.parse(v.strip(), mode="eval").body

        def ev(n):
            if isinstance(n, ast.Constant) and isinstance(n.value, int):
                return n.value
            if isinstance(n, ast.BinOp) and type(n.op) in _ALLOWED_OPS:
                return _ALLOWED_OPS[type(n.op)](ev(n.left), ev(n.right))
            raise ValueError(f"cannot parse int expression {v!r}")

        return ev(node)
    return int(v)


def _shape_arg(shape):
    if isinstance(shape, (int, str)):
        s = _int_arg(shape)
        return (s, s)
    return tuple(shape)


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# Qdense family
# ---------------------------------------------------------------------------
# ``init_batch`` is the JAX package's flax-init sample; only a lazily
# fitted PCA reads it (``_ReuploadShim``).

class QDenseUndirected_old(DenoiserShim):
    """Reference nn/qdense.py:15-68: qw_map.tanh weights."""

    def __init__(self, qdepth, shape, seed: int = 0, init_batch=None, *,
                 device=None):
        qdepth, shape = _int_arg(qdepth), _shape_arg(shape)
        self.qdepth, (self.width, self.height) = qdepth, shape
        module = _QDenseModule(qdepth, shape, generator=_generator(seed),
                               weight_map="qw_tanh")
        self.wires = module.wires
        super().__init__(
            module, shape, device=device,
            save_name_str=f"QDenseUndirected_old{qdepth}_w{shape[0]}"
                          f"_h{shape[1]}")


class QDenseUndirected_old_noise(DenoiserShim):
    """Reference nn/qdense.py:71-125 (the papers' "Qdense" baseline):
    torch.tanh weights."""

    def __init__(self, qdepth, shape, add_noise=0,
                 device_type="default.qubit.torch", seed: int = 0,
                 init_batch=None, *, device=None):
        qdepth, add_noise = _int_arg(qdepth), _int_arg(add_noise)
        shape = _shape_arg(shape)
        self.qdepth, self.add_noise = qdepth, add_noise
        self.width, self.height = shape
        module = _QDenseModule(qdepth, shape, generator=_generator(seed),
                               weight_map="tanh", add_noise=add_noise)
        self.wires = module.wires
        super().__init__(
            module, shape, device=device,
            save_name_str=(f"QDenseUndirected_old_noise{qdepth}"
                           f"_w{shape[0]}_h{shape[1]}_noise{add_noise}"))


class QNN_A(DenoiserShim):
    """Reference nn/qdense.py:128-210: RY product state, CNOT ring."""

    def __init__(self, qdepth, shape, add_noise=0,
                 device_type="default.qubit.torch", diff_method="backprop",
                 seed: int = 0, init_batch=None, *, device=None):
        qdepth, add_noise = _int_arg(qdepth), _int_arg(add_noise)
        shape = _shape_arg(shape)
        self.qdepth, self.add_noise = qdepth, add_noise
        self.width, self.height = shape
        module = _QNNAModule(qdepth, shape, generator=_generator(seed),
                             add_noise=add_noise)
        super().__init__(
            module, shape, device=device,
            save_name_str=(f"QNN_A{qdepth}_w{shape[0]}_h{shape[1]}"
                           f"_noise{add_noise}"))


# ---------------------------------------------------------------------------
# QNN family
# ---------------------------------------------------------------------------

def _qnn(input_dim, hidden_features, qdepth, seed, add_noise=0):
    input_dim, hidden = _int_arg(input_dim), _int_arg(hidden_features)
    qdepth = _int_arg(qdepth)
    module = _QNNDenseModule(input_dim, hidden, qdepth,
                             generator=_generator(seed), add_noise=add_noise)
    return module, _square_or_flat(input_dim), hidden, qdepth


class QNN_noise(DenoiserShim):
    """Reference nn/qdense.py:219-307 (mnist_exm's second default
    model, ``QNN_noise 784 8 14``)."""

    def __init__(self, input_dim, hidden_features, qdepth, add_noise=0,
                 seed: int = 0, init_batch=None, *, device=None):
        add_noise = _int_arg(add_noise)
        module, shape, hidden, qdepth = _qnn(input_dim, hidden_features,
                                             qdepth, seed, add_noise)
        self.hidden_features, self.qdepth = hidden, qdepth
        self.add_noise = add_noise
        super().__init__(
            module, shape, device=device,
            save_name_str=(f"QNN_linear_features={hidden}"
                           f"_qdepth={qdepth}_add_noise={add_noise}"))


class QNN(DenoiserShim):
    """Reference nn/qdense.py:310-386."""

    def __init__(self, input_dim, hidden_features, qdepth, seed: int = 0,
                 init_batch=None, *, device=None):
        module, shape, hidden, qdepth = _qnn(input_dim, hidden_features,
                                             qdepth, seed)
        self.hidden_features, self.qdepth = hidden, qdepth
        super().__init__(
            module, shape, device=device,
            save_name_str=f"QNN_linear_features={hidden}_qdepth={qdepth}")


# ---------------------------------------------------------------------------
# re-uploading (QIDDM) family
# ---------------------------------------------------------------------------

def _init_batch(init_batch, shape, seed: int) -> torch.Tensor:
    """The lazy PCA's fit batch on the CPU: ``init_batch`` as float32, or
    32 uniform images from a generator seeded ``seed + 1`` (the JAX shim
    draws them from ``PRNGKey(seed + 1)``)."""
    if init_batch is None:
        return torch.rand((32, 1, *shape), generator=_generator(seed + 1))
    if torch.is_tensor(init_batch):
        return init_batch.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(init_batch, dtype=np.float32))


class _ReuploadShim(DenoiserShim):
    def __init__(self, module, shape, save_name_str, *, device, seed=0,
                 init_batch=None, **attrs):
        if module.needs_init_batch:
            # fitted on the CPU before the move, so every device holds the
            # same PCA
            module.fit_lazy_pca(_init_batch(init_batch, shape, seed))
        super().__init__(module, shape, save_name_str=save_name_str,
                         device=device)
        for k, v in attrs.items():
            setattr(self, k, v)


def _differn(shape, spectrum_layer, N, seed, *, add_noise=None,
             family="qiddm", **options):
    """The differN (QIDDM-A) circuit: ``wires`` = ceil(log2(pixels)), N
    re-uploading blocks with the probabilities readout, post-processed to
    pixels (``up="none"``), down to ``wires`` by a PCA unless ``options``
    say otherwise. The attributes are the JAX shim's, ``add_noise`` where
    the class takes it."""
    shape = _shape_arg(shape)
    L, N = _int_arg(spectrum_layer), _int_arg(N)
    wires = math.ceil(math.log2(shape[0] * shape[1]))
    attrs = dict(spectrum_layer=L, N=N)
    if add_noise is not None:
        attrs["add_noise"] = add_noise = _int_arg(add_noise)
    options.setdefault("down", "pca")
    module = _ReuploadModule(wires, L, N, generator=_generator(seed),
                             shape=shape, up="none", readout="probs",
                             add_noise=add_noise or 0, noise_family=family,
                             **options)
    return module, shape, wires, attrs


class differN_noise(_ReuploadShim):
    """Reference nn/qdense.py:389-478 (the papers' "QIDDM-A", a default
    model of the noise driver): the Qdense family's noise, once at the
    end."""

    def __init__(self, shape, spectrum_layer, N, add_noise=0, seed: int = 0,
                 init_batch=None, *, device=None):
        m, shape, wires, attrs = _differn(shape, spectrum_layer, N, seed,
                                          add_noise=add_noise,
                                          family="qdense")
        name = (f"differN_old_pca={attrs['spectrum_layer']}_N={attrs['N']}"
                f"_w{shape[0]}_h{shape[1]}_noise{attrs['add_noise']}")
        super().__init__(m, shape, name, device=device, wires=wires,
                         **attrs)


class differN_noise_befor(_ReuploadShim):
    """Reference nn/qdense.py:481-562: the noise after each encode, inside
    the re-upload loop."""

    def __init__(self, shape, spectrum_layer, N, add_noise=0,
                 device_type="default.qubit.torch", seed: int = 0,
                 init_batch=None, *, device=None):
        m, shape, wires, attrs = _differn(shape, spectrum_layer, N, seed,
                                          add_noise=add_noise,
                                          family="differn_befor")
        name = (f"differN_noise={attrs['spectrum_layer']}_N={attrs['N']}"
                f"_w{shape[0]}_h{shape[1]}")
        super().__init__(m, shape, name, device=device, wires=wires,
                         **attrs)


class _DifferN(_ReuploadShim):
    """A differN-family class without noise, ``(shape, spectrum_layer, N,
    seed=0, init_batch=None)``: the circuit of :func:`_differn` with the
    class's ``_options``, saved under ``_save`` (formatted with L, N and
    the shape's w and h)."""

    _save = ""
    _options: dict = {}

    def __init__(self, shape, spectrum_layer, N, seed: int = 0,
                 init_batch=None, *, device=None):
        m, shape, wires, attrs = _differn(shape, spectrum_layer, N, seed,
                                          **self._options)
        name = self._save.format(L=attrs["spectrum_layer"], N=attrs["N"],
                                 w=shape[0], h=shape[1])
        super().__init__(m, shape, name, device=device, seed=seed,
                         init_batch=init_batch, wires=wires, **attrs)


class differN_old_pca(_DifferN):
    """Reference nn/qdense.py:671-743."""

    _save = "differN_old_pca={L}_N={N}_w{w}_h{h}"


class differN_new_pca(_DifferN):
    """Reference nn/qdense.py:747-835: the probabilities post-processed
    after each block."""

    _save = "differN_new_pca={L}_N={N}_w{w}_h{h}"
    _options = dict(post_each_block=True)


class differN_new_conv(_DifferN):
    """Reference nn/qdense.py:838-935: conv down, post-processed after each
    block."""

    _save = "differN_new_conv={L}_N={N}_w{w}_h{h}"
    _options = dict(down="conv", post_each_block=True)


class differN_old_conv(_DifferN):
    """Reference nn/qdense.py:939-1011: conv down."""

    _save = "differN_old_conv={L}_N={N}_w{w}_h{h}"
    _options = dict(down="conv")


class QIDDM_A_sameN(_DifferN):
    """Reference nn/qdense.py:2276-2342: no projection (the block encodes
    the first pixels) and one set of block weights shared by every
    block."""

    _save = "QIDDM_A_sameN={L}_N={N}_w{w}_h{h}"
    _options = dict(down="none", shared_weights=True)


class _QIDDMA(_ReuploadShim):
    """The pi/2-scaled RZ differN circuit, post-processed after each block
    (``input_dim`` is the image SIDE, not the pixel count), saved under
    ``_save`` (formatted with ``wires``, L and N)."""

    _save = ""

    def __init__(self, input_dim, spectrum_layer, N, seed: int = 0,
                 init_batch=None, *, device=None):
        m, shape, wires, attrs = _differn(
            (_int_arg(input_dim),) * 2, spectrum_layer, N, seed,
            encode="rz_halfpi", post_each_block=True)
        name = self._save.format(wires=wires, L=attrs["spectrum_layer"],
                                 N=attrs["N"])
        super().__init__(m, shape, name, device=device, seed=seed,
                         init_batch=init_batch, hidden_features=wires,
                         **attrs)


class QIDDM_A_differN_basePL(_QIDDMA):
    """Reference nn/qdense.py:2182-2273."""

    _save = "QIDDM_pca_features={wires}_L={L}_N={N}"


class QIDDM_A_differN_NEW(_QIDDMA):
    """Reference nn/qdense.py:2345-2437 (the same circuit as basePL)."""

    _save = "QIDDM_pca_new={wires}_L={L}_N={N}"


def _qiddm(input_dim, hidden, L, N, *, down, up, save, seed, encode="rz",
           k=2, add_noise=0, noise_intensity=None, **options):
    """The QIDDM-L family: PauliZ readout between two projections, with
    ``Reupload``'s ``options``. The attributes are the JAX shim's,
    ``add_noise`` where the class takes it."""
    input_dim, hidden = _int_arg(input_dim), _int_arg(hidden)
    L, N = _int_arg(L), _int_arg(N)
    attrs = dict(hidden_features=hidden, spectrum_layer=L, N=N)
    if add_noise is not None:
        attrs["add_noise"] = add_noise = _int_arg(add_noise)
    shape = _square_or_flat(input_dim)
    module = _ReuploadModule(
        hidden, L, N, generator=_generator(seed),
        input_dim=input_dim, shape=shape, k=k, down=down, up=up,
        readout="expvalz", encode=encode, add_noise=add_noise or 0,
        noise_family="qiddm", noise_intensity=noise_intensity, **options)
    return module, shape, save.format(h=hidden, L=L, N=N), attrs


class _QIDDM(_ReuploadShim):
    """A QIDDM-L-family class without noise, ``(input_dim,
    hidden_features, spectrum_layer, N, seed=0, init_batch=None)``: the
    circuit of :func:`_qiddm` with the class's ``_options``, saved under
    ``_save`` (formatted with h, L and N)."""

    _save = ""
    _options: dict = {}

    def __init__(self, input_dim, hidden_features, spectrum_layer, N,
                 seed: int = 0, init_batch=None, *, device=None):
        m, shape, name, attrs = _qiddm(input_dim, hidden_features,
                                       spectrum_layer, N, add_noise=None,
                                       seed=seed, save=self._save,
                                       **self._options)
        super().__init__(m, shape, name, device=device, seed=seed,
                         init_batch=init_batch, **attrs)


class _NoisyQIDDM(_ReuploadShim):
    """A QIDDM-L-family class with the reference's ``add_noise`` and
    ``device_type`` arguments and no ``noise_intensity``."""

    _save = ""
    _options: dict = {}

    def __init__(self, input_dim, hidden_features, spectrum_layer, N,
                 add_noise=0, device_type="lightning.qubit", seed: int = 0,
                 init_batch=None, *, device=None):
        m, shape, name, attrs = _qiddm(input_dim, hidden_features,
                                       spectrum_layer, N,
                                       add_noise=add_noise, seed=seed,
                                       save=self._save, **self._options)
        super().__init__(m, shape, name, device=device, seed=seed,
                         init_batch=init_batch, **attrs)


class QIDDM_LL_noise(_ReuploadShim):
    """Reference nn/qdense.py:1567-1660 (default model of the mnist driver
    and the Ray sweep): Linear down, N x L re-uploading blocks, PauliZ
    readout, Linear up."""

    def __init__(self, input_dim, hidden_features, spectrum_layer, N,
                 add_noise=0, device_type="lightning.qubit", seed: int = 0,
                 noise_intensity=None, init_batch=None, *, device=None):
        m, shape, name, attrs = _qiddm(input_dim, hidden_features,
                                       spectrum_layer, N, down="linear",
                                       up="linear", add_noise=add_noise,
                                       noise_intensity=noise_intensity,
                                       seed=seed,
                                       save="QIDDM_LL_noise={h}_L={L}_N={N}")
        super().__init__(m, shape, name, device=device, **attrs)


class QIDDM_PL(_QIDDM):
    """Reference nn/qdense.py:1271-1368 (the papers' "QIDDM-L" flagship):
    PCA down, linear up, PauliZ readout."""

    _save = "QIDDM_PL={h}_L={L}_N={N}"
    _options = dict(down="pca", up="linear")


class QIDDM_PL_old(_QIDDM):
    """Reference nn/qdense.py:1176-1250."""

    _save = "QIDDM_PL_old_q={h}_L={L}_N={N}"
    _options = dict(down="pca", up="linear")


class QIDDM_PL_noise(_ReuploadShim):
    """Reference nn/qdense.py:1371-1466 (a default model of the noise
    driver, ``QIDDM_PL_noise 64 4 2 1``)."""

    def __init__(self, input_dim, hidden_features, spectrum_layer, N,
                 add_noise=0, device_type="lightning.qubit", seed: int = 0,
                 noise_intensity=None, init_batch=None, *, device=None):
        m, shape, name, attrs = _qiddm(input_dim, hidden_features,
                                       spectrum_layer, N, down="pca",
                                       up="linear", add_noise=add_noise,
                                       noise_intensity=noise_intensity,
                                       seed=seed,
                                       save="QIDDM_PL_noise={h}_L={L}_N={N}")
        super().__init__(m, shape, name, device=device, **attrs)


class QIDDM_PL_noise1(_ReuploadShim):
    """Reference nn/qdense.py:565-667: PCA down, RY re-upload, PauliZ
    readout, linear up.

    Faithful quirk: the reference gives this class the same ``save_name``
    format as ``QIDDM_PL_noise`` (reference :646 and :1466), so checkpoints
    of the RY and the RZ circuit collide on disk; use distinct save paths
    when training both.
    """

    def __init__(self, input_dim, hidden_features, spectrum_layer, N,
                 add_noise=0, device_type="lightning.qubit", seed: int = 0,
                 init_batch=None, *, device=None):
        m, shape, name, attrs = _qiddm(input_dim, hidden_features,
                                       spectrum_layer, N, down="pca",
                                       up="linear", encode="ry",
                                       add_noise=add_noise, seed=seed,
                                       save="QIDDM_PL_noise={h}_L={L}_N={N}")
        super().__init__(m, shape, name, device=device, **attrs)


class QIDDM_LL_relu_noise(_NoisyQIDDM):
    """Reference nn/qdense.py:1469-1564: its ReLU is built and never
    applied, and it saves under ``QIDDM_LL_noise``'s name; reproduced as
    the plain LL circuit."""

    _save = "QIDDM_LL_noise={h}_L={L}_N={N}"
    _options = dict(down="linear", up="linear")


class QIDDM_LL_old(_QIDDM):
    """Reference nn/qdense.py:1873-1968."""

    _save = "QIDDM_linear_features={h}_L={L}_N={N}"
    _options = dict(down="linear", up="linear")


class QIDDM_L(QIDDM_LL_old):
    """Missing from the reference release though imported by its drivers:
    the linear-down / linear-up QIDDM variant, as the JAX package
    provides it."""


class QIDDM_bias_false(_QIDDM):
    """Reference nn/qdense.py:1971-2074: ``linear_down`` without a bias
    (``linear_up`` keeps its own), k = 3 SEL layers."""

    _save = "QIDDM_linear_features={h}_L={L}_N={N}"
    _options = dict(down="linear", up="linear", bias=False, k=3)


class QIDDM_L_B(_QIDDM):
    """Reference nn/qdense.py:2077-2179: ONE BatchNorm before every block,
    k = 3."""

    _save = "QIDDM_linear_batch_features={h}_L={L}_N={N}"
    _options = dict(down="linear", up="linear", k=3,
                    batchnorm_pre_block=True)


class QIDDM_CL_new(_QIDDM):
    """Reference nn/qdense.py:1014-1100: conv down, linear up."""

    _save = "QIDDM_CL_new_q={h}_L={L}_N={N}"
    _options = dict(down="conv", up="linear")


class QIDDM_CL_old(_QIDDM):
    """Reference nn/qdense.py:1104-1173."""

    _save = "QIDDM_CL_old_q={h}_L={L}_N={N}"
    _options = dict(down="conv", up="linear")


class QIDDM_PP_noise(_NoisyQIDDM):
    """Reference nn/qdense.py:1663-1753: PCA down (refitted on every
    batch), inverse PCA up."""

    _save = "QIDDM_PP_noise={h}_L={L}_N={N}"
    _options = dict(down="pca", up="pca_inverse")


class QIDDM_PP_old(_QIDDM):
    """Reference nn/qdense.py:1756-1870: a lazily fitted PCA(2h) ->
    BatchNorm (``pca_bn``) -> Linear(h) down, Linear(2h) -> inverse PCA
    up; the PCA travels in the checkpoint (``pca_state``)."""

    _save = "QIDDM_PP_features={h}_L={L}_N={N}"
    _options = dict(down="pca2_bn_linear", up="linear_then_pca_inverse",
                    pca_lazy=True)
