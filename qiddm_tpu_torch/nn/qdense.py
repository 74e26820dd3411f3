"""The reference's dense quantum models by public name (counterpart of
``qiddm_tpu/nn/qdense.py``). Same constructor signatures and byte-identical
``save_name()`` strings as the JAX package. Ported so far: the Qdense
baseline (``QDenseUndirected_old``, ``QDenseUndirected_old_noise``),
``QNN_A``, the QNN pair (``QNN_noise``, ``QNN``), ``QIDDM_LL_noise``, the
PCA-down family (``QIDDM_PL``, ``QIDDM_PL_old``, ``QIDDM_PL_noise``,
``QIDDM_PL_noise1``) and the noise drivers' differN pair
(``differN_noise``, ``differN_noise_befor``), each with every ``add_noise``
code the reference knows (0-4) and, where the JAX class takes one, a
``noise_intensity``; the rest of the zoo is ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import ast
import math
import operator as _op

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
# ``init_batch`` is the JAX package's flax-init sample; the port's modules
# need none and ignore it.

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

class _ReuploadShim(DenoiserShim):
    def __init__(self, module, shape, save_name_str, *, device, **attrs):
        super().__init__(module, shape, save_name_str=save_name_str,
                         device=device)
        for k, v in attrs.items():
            setattr(self, k, v)


def _differn(shape, spectrum_layer, N, add_noise, seed, family):
    """The differN (QIDDM-A) circuit: PCA down to ``wires`` =
    ceil(log2(pixels)) components, N re-uploading blocks with the
    probabilities readout, post-processed to pixels (``up="none"``)."""
    shape = _shape_arg(shape)
    L, N = _int_arg(spectrum_layer), _int_arg(N)
    add_noise = _int_arg(add_noise)
    wires = math.ceil(math.log2(shape[0] * shape[1]))
    module = _ReuploadModule(wires, L, N, generator=_generator(seed),
                             shape=shape, down="pca", up="none",
                             readout="probs", add_noise=add_noise,
                             noise_family=family)
    attrs = dict(spectrum_layer=L, N=N, add_noise=add_noise, wires=wires)
    return module, shape, attrs


class differN_noise(_ReuploadShim):
    """Reference nn/qdense.py:389-478 (the papers' "QIDDM-A", a default
    model of the noise driver): the Qdense family's noise, once at the
    end."""

    def __init__(self, shape, spectrum_layer, N, add_noise=0, seed: int = 0,
                 init_batch=None, *, device=None):
        m, shape, attrs = _differn(shape, spectrum_layer, N, add_noise, seed,
                                   "qdense")
        name = (f"differN_old_pca={attrs['spectrum_layer']}_N={attrs['N']}"
                f"_w{shape[0]}_h{shape[1]}_noise{attrs['add_noise']}")
        super().__init__(m, shape, name, device=device, **attrs)


class differN_noise_befor(_ReuploadShim):
    """Reference nn/qdense.py:481-562: the noise after each encode, inside
    the re-upload loop."""

    def __init__(self, shape, spectrum_layer, N, add_noise=0,
                 device_type="default.qubit.torch", seed: int = 0,
                 init_batch=None, *, device=None):
        m, shape, attrs = _differn(shape, spectrum_layer, N, add_noise, seed,
                                   "differn_befor")
        name = (f"differN_noise={attrs['spectrum_layer']}_N={attrs['N']}"
                f"_w{shape[0]}_h{shape[1]}")
        super().__init__(m, shape, name, device=device, **attrs)


def _qiddm(input_dim, hidden, L, N, *, down, up, save, seed, encode="rz",
           k=2, add_noise=0, noise_intensity=None):
    """The QIDDM-L family: PauliZ readout between two projections. The
    attributes are the JAX shim's, ``add_noise`` where the class takes
    it."""
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
        noise_family="qiddm", noise_intensity=noise_intensity)
    return module, shape, save.format(h=hidden, L=L, N=N), attrs


class QIDDM_LL_noise(_ReuploadShim):
    """Reference nn/qdense.py:1567-1660 (default model of the mnist driver
    and the Ray sweep): Linear down, N x L re-uploading blocks, PauliZ
    readout, Linear up."""

    def __init__(self, input_dim, hidden_features, spectrum_layer, N,
                 add_noise=0, device_type="lightning.qubit", seed: int = 0,
                 noise_intensity=None, *, device=None):
        m, shape, name, attrs = _qiddm(input_dim, hidden_features,
                                       spectrum_layer, N, down="linear",
                                       up="linear", add_noise=add_noise,
                                       noise_intensity=noise_intensity,
                                       seed=seed,
                                       save="QIDDM_LL_noise={h}_L={L}_N={N}")
        super().__init__(m, shape, name, device=device, **attrs)


class QIDDM_PL(_ReuploadShim):
    """Reference nn/qdense.py:1271-1368 (the papers' "QIDDM-L" flagship):
    PCA down, linear up, PauliZ readout."""

    def __init__(self, input_dim, hidden_features, spectrum_layer, N,
                 seed: int = 0, init_batch=None, *, device=None):
        m, shape, name, attrs = _qiddm(input_dim, hidden_features,
                                       spectrum_layer, N, down="pca",
                                       up="linear", add_noise=None,
                                       seed=seed,
                                       save="QIDDM_PL={h}_L={L}_N={N}")
        super().__init__(m, shape, name, device=device, **attrs)


class QIDDM_PL_old(_ReuploadShim):
    """Reference nn/qdense.py:1176-1250."""

    def __init__(self, input_dim, hidden_features, spectrum_layer, N,
                 seed: int = 0, init_batch=None, *, device=None):
        m, shape, name, attrs = _qiddm(input_dim, hidden_features,
                                       spectrum_layer, N, down="pca",
                                       up="linear", add_noise=None,
                                       seed=seed,
                                       save="QIDDM_PL_old_q={h}_L={L}_N={N}")
        super().__init__(m, shape, name, device=device, **attrs)


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
