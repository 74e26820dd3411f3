"""The density-matrix pieces of qiddm_tpu_torch — ``sim/channels.py`` and
``sim/density.py`` — against qiddm_tpu on the same numpy inputs, on the
CPU.

Tolerance 1e-6 absolute: unit-trace density matrices of up to 16 x 16
through one or a few float32 channel or gate steps (the Kraus operators
themselves are float64 in both packages and agree to 1e-12).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qiddm_tpu import config as jconfig
from qiddm_tpu.sim import channels as jch
from qiddm_tpu.sim import density as jdm
from qiddm_tpu_torch import config as tconfig
from qiddm_tpu_torch.sim import channels as tch
from qiddm_tpu_torch.sim import density as tdm

TOL = 1e-6
KINDS = ["amplitude_damping", "depolarizing", "phase_damping"]


def _rho(b, w, seed=0):
    """A batch of random full-rank density matrices, complex64."""
    rng = np.random.default_rng(seed)
    d = 2**w
    a = rng.normal(size=(b, d, d)) + 1j * rng.normal(size=(b, d, d))
    rho = a @ a.conj().transpose(0, 2, 1)
    rho /= np.trace(rho, axis1=1, axis2=2)[:, None, None]
    return rho.astype(np.complex64)


def _unitary(w, seed=1):
    rng = np.random.default_rng(seed)
    d = 2**w
    q, _ = np.linalg.qr(rng.normal(size=(d, d))
                        + 1j * rng.normal(size=(d, d)))
    return q.astype(np.complex64)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol)


@pytest.fixture
def channel_mode(request):
    """Set ``dm_channel_mode`` in both packages, and restore it."""
    before = (jconfig.dm_channel_mode(), tconfig.dm_channel_mode())
    jconfig.set_dm_channel_mode(request.param)
    tconfig.set_dm_channel_mode(request.param)
    yield request.param
    jconfig.set_dm_channel_mode(before[0])
    tconfig.set_dm_channel_mode(before[1])


@pytest.mark.parametrize("kind", ["phase_shift"] + KINDS)
@pytest.mark.parametrize("strength", [0.05, 0.7])
def test_kraus_sets_match_jax_from_a_float_and_a_tensor(kind, strength):
    want = np.stack([np.asarray(k) for k in jch.kraus_for(kind, strength)])
    for s in (strength, torch.tensor(strength, dtype=torch.float64)):
        got = torch.stack(tch.kraus_for(kind, s))
        assert got.dtype == torch.complex128
        np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
    # a CPTP set: sum K^dagger K = I
    got = torch.stack(tch.kraus_for(kind, strength))
    eye = torch.einsum("kxa,kxb->ab", got.conj(), got)
    np.testing.assert_allclose(eye.numpy(), np.eye(2), atol=1e-12)


def test_kraus_of_a_tensor_strength_carries_its_gradient():
    g = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    k1 = tch.amplitude_damping(g)[1]
    k1[0, 1].real.backward()
    assert g.grad.item() == pytest.approx(0.5 / np.sqrt(0.3))
    with pytest.raises(ValueError, match="unknown channel"):
        tch.kraus_for("bit_flip", 0.1)


def test_states_zero_density_and_readouts_match_jax():
    rng = np.random.default_rng(2)
    st = (rng.normal(size=(3, 8)) + 1j * rng.normal(size=(3, 8)))
    st = (st / np.linalg.norm(st, axis=1, keepdims=True)).astype(np.complex64)
    _close(tdm.from_statevector(torch.as_tensor(st)),
           jdm.from_statevector(jnp.asarray(st)))
    _close(tdm.zero_density(2, 3), jdm.zero_density(2, 3))
    rho = _rho(2, 3)
    _close(tdm.probs(torch.as_tensor(rho)), jdm.probs(jnp.asarray(rho)))
    _close(tdm.expval_z(torch.as_tensor(rho)), jdm.expval_z(jnp.asarray(rho)))
    with pytest.raises(ValueError, match="capped at 12 wires"):
        tdm.zero_density(1, 13)
    with pytest.raises(ValueError, match="capped at 12 wires"):
        tdm.from_statevector(torch.zeros(1, 2**13, dtype=torch.complex64))


def test_unitary_diag_and_rz_encode_match_jax():
    rho, u = _rho(2, 3), _unitary(3)
    x = np.random.default_rng(3).normal(size=(2, 3)).astype(np.float32)
    tr, jr = torch.as_tensor(rho), jnp.asarray(rho)
    _close(tdm.apply_unitary(tr, torch.as_tensor(u)),
           jdm.apply_unitary(jr, jnp.asarray(u)))
    ph = np.exp(1j * np.random.default_rng(4).normal(size=(2, 8))).astype(
        np.complex64)
    _close(tdm.apply_diag(tr, torch.as_tensor(ph)),
           jdm.apply_diag(jr, jnp.asarray(ph)))
    _close(tdm.rz_encode(tr, torch.as_tensor(x)),
           jdm.rz_encode(jr, jnp.asarray(x)))


def test_chain_two_sided_matches_jax_and_the_sandwich():
    """The port's chain function works on (d, B) float32 planes, JAX's on
    (B, d) complex states; both give U rho U^dagger."""
    rho, u = _rho(3, 3), _unitary(3)
    ut = torch.as_tensor(u)

    def planes_chain(sr, si):
        out = ut @ torch.complex(sr, si)
        return out.real, out.imag

    got = tdm.apply_chain_two_sided(torch.as_tensor(rho), planes_chain)
    want = jdm.apply_chain_two_sided(jnp.asarray(rho),
                                     lambda cols: cols @ jnp.asarray(u).T)
    _close(got, want)
    _close(got, tdm.apply_unitary(torch.as_tensor(rho), ut))


@pytest.mark.parametrize("wire", [0, 1, 3])
def test_one_wire_kraus_and_closed_forms_match_jax(wire):
    rho = _rho(2, 4, seed=wire)
    tr, jr = torch.as_tensor(rho), jnp.asarray(rho)
    for kind in ["phase_shift"] + KINDS:
        k = np.stack([np.asarray(m) for m in jch.kraus_for(kind, 0.3)]
                     ).astype(np.complex64)
        _close(tdm.apply_1q_kraus(tr, torch.as_tensor(k), wire),
               jdm.apply_1q_kraus(jr, jnp.asarray(k), wire))
    _close(tdm._amp_damp_wire(tr, 0.3, wire, 4),
           jdm._amp_damp_wire(jr, 0.3, wire, 4))
    _close(tdm._depol_wire(tr, torch.tensor(0.3), wire, 4),
           jdm._depol_wire(jr, jnp.float32(0.3), wire, 4))


@pytest.mark.parametrize("strength", [0.03, 0.9])
def test_phase_damp_mask_matches_jax(strength):
    _close(tdm._phase_damp_mask(4, strength, torch.complex64),
           jdm._phase_damp_mask(4, strength, jnp.complex64))


@pytest.mark.parametrize("channel_mode", ["perwire", "grouped"],
                         indirect=True)
@pytest.mark.parametrize("strength", [0.05, 0.6])
@pytest.mark.parametrize("kind", KINDS)
def test_all_wires_channels_match_jax_in_both_modes(channel_mode, kind,
                                                    strength):
    """Both modes, the three kinds at two strengths, from a float and from
    a 0-d tensor, against the JAX closed forms and the generic Kraus sum."""
    rho = _rho(2, 5, seed=7)
    want = jdm.apply_channel_all_wires(jnp.asarray(rho), kind, strength)
    for s in (strength, torch.tensor(strength, dtype=torch.float32)):
        got = tdm.apply_channel_all_wires(torch.as_tensor(rho), kind, s)
        _close(got, want)
    k = torch.stack(tch.kraus_for(kind, strength)).to(torch.complex64)
    _close(tdm.apply_kraus_all_wires(torch.as_tensor(rho), k), want)


def test_unknown_closed_form_raises_keyerror():
    with pytest.raises(KeyError):
        tdm.apply_channel_all_wires(torch.as_tensor(_rho(1, 2)),
                                    "phase_shift", 0.1)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_grouped_transfer_matches_jax(group):
    kraus = np.stack([np.asarray(m) for m in
                      jch.kraus_for("amplitude_damping", 0.2)]).astype(
        np.complex64)
    t_t = tdm.transfer_tensor(torch.as_tensor(kraus))
    t_j = jdm.transfer_tensor(jnp.asarray(kraus))
    _close(t_t, t_j)
    _close(tdm._group_transfer(t_t, 3), jdm._group_transfer(t_j, 3))
    rho = _rho(2, 5, seed=9)
    _close(tdm.apply_channel_all_wires_grouped(torch.as_tensor(rho),
                                               torch.as_tensor(kraus), group),
           jdm.apply_channel_all_wires_grouped(jnp.asarray(rho),
                                               jnp.asarray(kraus), group))


def test_mode_setters_validate_and_default():
    assert tconfig.dm_unitary_mode() == "gates"
    assert tconfig.dm_channel_mode() == "perwire"
    with pytest.raises(ValueError):
        tconfig.set_dm_unitary_mode("fast")
    with pytest.raises(ValueError):
        tconfig.set_dm_channel_mode("fast")
