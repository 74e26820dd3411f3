"""The forward kernels as operators of one ``torch.library`` namespace,
``qiddm``, so that ``torch.export`` can trace a sampler that runs them
(``qiddm_tpu_torch/export.py``).

A kernel is launched through ``ctypes`` on ``data_ptr()``, which the fake
tensors of a trace do not have. Each forward kernel that an exportable
sampler can launch is therefore an operator with three implementations:

* ``CUDA``: the kernel's launch function as it is (its launch counter goes
  on counting, from a loaded artifact too); a failed build or launch
  raises;
* ``CPU``: the kernel's plain PyTorch version;
* fake: the output shapes and dtypes, which is all a trace needs.

The autograd Functions of the kernel modules call these operators in their
forward passes, so the live path and an exported program go through the
same operator, and the choice between kernel and plain version is the
dispatcher's, by the device of the inputs. The backward kernels and the
trajectory-only kernels (the SEL chain on rows, the amplitude-damping
pass) are not operators: a trajectory sampler draws fresh noise on every
call and is never exported.

``qiddm::gate_chain`` and ``qiddm::sel_chain`` also have a batching rule
(``torch.library.register_vmap``), so ``torch.func.vmap`` of a circuit
over its weights (``sim/gradients.py``'s parameter shift) reaches them: the
rule runs the operator once for each member of the vmapped dimension, so
on the card #1 (or #5) launches once for each weight set.

The operators are registered with the low-level ``torch.library.Library``
(``define``, ``impl`` for each device, ``register_fake``), the cheaper of
the two registrations: ``chip_smoke.py``'s phase 47 times #1 through its
launch function, through this operator and through the same function
registered with ``torch.library.custom_op``, in turns (``PERF.md``).

| operator | kernel | launch function |
| --- | --- | --- |
| ``qiddm::gate_chain`` | #1 | ``gate_kernel._gate_chain_cuda`` |
| ``qiddm::ry_chain`` | #3 | ``ry_kernel._ry_chain_cuda`` |
| ``qiddm::sel_chain`` | #5 on planes | ``sel_kernel._sel_chain_cuda`` |
| ``qiddm::dm_chain`` | #8 | ``dm_kernel._dm_chain_cuda`` |
| ``qiddm::wide_chain`` | #11 | ``wide_kernel._wide_chain_cuda`` |
| ``qiddm::wide_mono`` | #9 | ``wide_kernel._wide_mono_cuda`` |
| ``qiddm::unitary_chain`` | #13 | ``unitary_kernel._unitary_chain_cuda`` |
"""

from __future__ import annotations

import torch

from . import dm_kernel as _dm
from . import gate_kernel as _gk
from . import ry_kernel as _ry
from . import sel_kernel as _sel
from . import unitary_kernel as _uk
from . import wide_kernel as _wk

NAMESPACE = "qiddm"
LIB = torch.library.Library(NAMESPACE, "DEF")

_KIND_NAMES = {v: k for k, v in _dm.KIND_IDS.items()}


def _register(name: str, schema: str, cpu, cuda, fake) -> None:
    LIB.define(f"{name}{schema}")
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)


# --- #1, the RZ gate chain ---------------------------------------------------

def _gate_chain_cpu(pr, pi, g8, k: int, wires: int):
    return _gk._chain_plain(pr, pi, g8,
                            _gk._sign_planes_on(k, wires, pr.device), k,
                            wires)


def _gate_chain_cuda(pr, pi, g8, k: int, wires: int):
    return _gk._gate_chain_cuda(pr, pi, g8,
                                _gk._sign_planes_on(k, wires, pr.device), k,
                                wires)


def _planes_like(pr, pi, *rest):
    return torch.empty_like(pr), torch.empty_like(pi)


_register("gate_chain",
          "(Tensor pr, Tensor pi, Tensor g8, int k, int wires) "
          "-> (Tensor, Tensor)", _gate_chain_cpu, _gate_chain_cuda,
          _planes_like)


# --- #3, the RY chain --------------------------------------------------------

def _ry_chain_cpu(cs, g8, k: int, wires: int):
    return _ry._ry_plain(cs, g8, _gk._sign_planes_on(k, wires, cs.device),
                         k, wires)


def _ry_chain_cuda(cs, g8, k: int, wires: int):
    return _ry._ry_chain_cuda(cs, g8,
                              _gk._sign_planes_on(k, wires, cs.device), k,
                              wires)


def _ry_fake(cs, g8, k: int, wires: int):
    out = cs.new_empty((2**wires, cs.shape[1]))
    return out, torch.empty_like(out)


_register("ry_chain", "(Tensor cs, Tensor g8, int k, int wires) "
          "-> (Tensor, Tensor)", _ry_chain_cpu, _ry_chain_cuda, _ry_fake)


# --- #5, the SEL chain on planes ---------------------------------------------

_register("sel_chain",
          "(Tensor sr, Tensor si, Tensor g8, int wires, str imprimitive) "
          "-> (Tensor, Tensor)", _sel._sel_plain, _sel._sel_chain_cuda,
          _planes_like)


# --- #8, the density-matrix block --------------------------------------------

def _mats_of(g8):
    """Packed (..., 8) float32 gates back to complex64 (..., 2, 2) matrices
    (exact: ``_to_g8`` only splits them)."""
    return torch.complex(g8[..., 0::2], g8[..., 1::2]).reshape(
        *g8.shape[:-1], 2, 2)


def _dm_chain_cpu(enc, g8, strength, value: float, k: int, wires: int,
                  kind_id: int, ry: bool):
    return _dm.dm_chain_plain(enc, _mats_of(g8), k, wires,
                              _KIND_NAMES[kind_id],
                              value if strength is None else strength, ry=ry)


def _dm_chain_cuda(enc, g8, strength, value: float, k: int, wires: int,
                   kind_id: int, ry: bool):
    if strength is not None:
        value = strength.to(torch.float32).reshape(()).contiguous()
    return _dm._dm_chain_cuda(enc, g8, value, k, wires, kind_id, ry)


def _dm_fake(enc, g8, strength, value: float, k: int, wires: int,
             kind_id: int, ry: bool):
    d = 2**wires
    return g8.new_empty((enc.shape[0], d, d), dtype=torch.complex64)


_register("dm_chain",
          "(Tensor enc, Tensor g8, Tensor? strength, float value, int k, "
          "int wires, int kind_id, bool ry) -> Tensor", _dm_chain_cpu,
          _dm_chain_cuda, _dm_fake)


# --- #11 and #9, the wide chain's two kernel variants ------------------------

def _wide_cpu(pr, pi, gplanes, k: int, wires: int):
    return _wk._chain_plain(pr, pi, gplanes,
                            _gk._sign_planes_on(k, wires, pr.device), k,
                            wires)


_WIDE_SCHEMA = ("(Tensor pr, Tensor pi, Tensor[] gplanes, int k, int wires) "
                "-> (Tensor, Tensor)")
_register("wide_chain", _WIDE_SCHEMA, _wide_cpu, _wk._wide_chain_cuda,
          _planes_like)
_register("wide_mono", _WIDE_SCHEMA, _wide_cpu, _wk._wide_mono_cuda,
          _planes_like)


# --- #13, the unitary-streaming chain ----------------------------------------

_register("unitary_chain",
          "(Tensor pr, Tensor pi, Tensor ur, Tensor ui, int k) "
          "-> (Tensor, Tensor)", _uk.unitary_chain_planes_plain,
          _uk._unitary_chain_cuda, _planes_like)


def _each_member(op):
    """A batching rule that runs ``op`` once for each member of the
    vmapped dimension and stacks the outputs along dimension 0."""

    def rule(info, in_dims, *args):
        outs = []
        for i in range(info.batch_size):
            one = [a if d is None else a.select(d, i).contiguous()
                   for a, d in zip(args, in_dims)]
            outs.append(op(*one))
        return (tuple(torch.stack(o) for o in zip(*outs)),
                (0,) * len(outs[0]))

    return rule


gate_chain = torch.ops.qiddm.gate_chain.default
ry_chain = torch.ops.qiddm.ry_chain.default
sel_chain = torch.ops.qiddm.sel_chain.default
dm_chain = torch.ops.qiddm.dm_chain.default
wide_chain = torch.ops.qiddm.wide_chain.default
wide_mono = torch.ops.qiddm.wide_mono.default
unitary_chain = torch.ops.qiddm.unitary_chain.default

# every operator, by name: the kernels an exported sampler may launch
OPS = {"gate_chain": gate_chain, "ry_chain": ry_chain,
       "sel_chain": sel_chain, "dm_chain": dm_chain,
       "wide_chain": wide_chain, "wide_mono": wide_mono,
       "unitary_chain": unitary_chain}
for _name in ("gate_chain", "sel_chain"):
    torch.library.register_vmap(f"{NAMESPACE}::{_name}",
                                _each_member(OPS[_name]), lib=LIB)
