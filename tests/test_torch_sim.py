"""qiddm_tpu_torch.sim against qiddm_tpu.sim on the CPU: the same numpy
inputs through both packages.

Tolerances: the closed forms (gates, tables, phases, readouts, composed
unitaries, the RY product state and RY gates) agree to <= 1e-6 at float32
— a few ulp of cos/sin/exp and of 64-term sums. ``reupload_block`` runs up
to 28 gate layers through different formulations in the two packages (the
RZ or RY gate chain or composed unitaries here, per-layer unitaries or
composed unitaries in JAX), so it is held to <= 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import sim as jsim
from qiddm_tpu.sim import sel as jsel
from qiddm_tpu.sim import statevector as jsv
from qiddm_tpu_torch import sim as tsim
from qiddm_tpu_torch.sim import engine as tengine
from qiddm_tpu_torch.sim import sel as tsel
from qiddm_tpu_torch.sim import statevector as tsv

CLOSED_FORM_TOL = 1e-6
CHAIN_TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def test_rot_matrix_matches_jax():
    a = _rng(1).normal(size=(3, 5, 4)).astype(np.float32) * 3
    want = np.asarray(jsim.rot_matrix(a[0], a[1], a[2]))
    t = torch.as_tensor(a)
    got = tsim.rot_matrix(t[0], t[1], t[2])
    assert got.dtype == torch.complex64 and got.shape == (5, 4, 2, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=CLOSED_FORM_TOL)


@pytest.mark.parametrize("wires", [1, 3, 6])
def test_tables_match_jax(wires):
    np.testing.assert_array_equal(tsv.bit_table(wires), jsv.bit_table(wires))
    np.testing.assert_array_equal(tsv.z_sign_table(wires),
                                  jsv.z_sign_table(wires))
    assert tsel.sel_ranges(5, wires) == jsel.sel_ranges(5, wires)
    for rng in range(wires):
        np.testing.assert_array_equal(tsel.cz_ring_signs(wires, rng),
                                      jsel.cz_ring_signs(wires, rng))


@pytest.mark.parametrize("wires,batch", [(4, 3), (6, 16)])
def test_phases_and_readouts_match_jax(wires, batch):
    rng = _rng(2)
    x = rng.normal(size=(batch, wires)).astype(np.float32)
    jpr, jpi = jsv.rz_phase_planes(jnp.asarray(x), wires)
    tpr, tpi = tsv.rz_phase_planes(torch.as_tensor(x), wires)
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr),
                               atol=CLOSED_FORM_TOL)
    np.testing.assert_allclose(tpi.numpy(), np.asarray(jpi),
                               atol=CLOSED_FORM_TOL)
    np.testing.assert_allclose(
        tsv.rz_phases(torch.as_tensor(x), wires).numpy(),
        np.asarray(jsv.rz_phases(jnp.asarray(x), wires)),
        atol=CLOSED_FORM_TOL)

    st = rng.normal(size=(2, 2**wires, batch)).astype(np.float32)
    st /= np.sqrt((st ** 2).sum(axis=(0, 1), keepdims=True))
    sr, si = torch.as_tensor(st[0]), torch.as_tensor(st[1])
    np.testing.assert_allclose(
        tsv.expval_z_from_planes(sr, si).numpy(),
        np.asarray(jsv.expval_z_from_planes(jnp.asarray(st[0]),
                                            jnp.asarray(st[1]))),
        atol=CLOSED_FORM_TOL)
    np.testing.assert_allclose(
        tsv.probs_from_planes(sr, si).numpy(),
        np.asarray(jsv.probs_from_planes(jnp.asarray(st[0]),
                                         jnp.asarray(st[1]))),
        atol=CLOSED_FORM_TOL)


@pytest.mark.parametrize("wires,k", [(1, 2), (4, 2), (6, 3)])
def test_sel_unitaries_match_jax(wires, k):
    w = (_rng(3).normal(size=(2, k, wires, 3)) * 0.4).astype(np.float32)
    want = np.asarray(jsel.sel_unitaries(jnp.asarray(w), imprimitive="cz"))
    got = tsel.sel_unitaries(torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(got, want, atol=CLOSED_FORM_TOL)


# batch 5 < 2^4 takes the gate chain, batch 20 >= 2^4 the composed route
@pytest.mark.parametrize("batch", [5, 20])
@pytest.mark.parametrize("readout,encode", [("probs", "rz"),
                                            ("expvalz", "rz"),
                                            ("expvalz", "rz_halfpi"),
                                            ("expvalz", "ry"),
                                            ("probs", "ry")])
def test_reupload_block_matches_jax(batch, readout, encode):
    wires, L, k = 4, 3, 2
    rng = _rng(4)
    x = rng.normal(size=(batch, wires)).astype(np.float32)
    w = (rng.normal(size=(L, k, wires, 3)) * 0.4).astype(np.float32)
    want = np.asarray(jsim.reupload_block(
        jnp.asarray(x), jnp.asarray(w), encode=encode, imprimitive="cz",
        readout=readout))
    with torch.no_grad():
        got = tsim.reupload_block(torch.as_tensor(x), torch.as_tensor(w),
                                  encode=encode, readout=readout).numpy()
    np.testing.assert_allclose(got, want, atol=CHAIN_TOL)


_DAMPING = tengine.NoiseModel("amplitude_damping", 0.1, "encode")


@pytest.mark.parametrize("kwargs,item", [
    # the trajectory backend: a channel with n_traj needs a random source
    # and runs at any width; without a channel n_traj changes nothing
    ({"noise": _DAMPING, "n_traj": 4}, "random source"),
    ({"n_traj": 4}, None),
    # ROADMAP item 11's mesh half: a one-rank mesh runs the sharded route
    ({"mesh": "one rank"}, "item 11"),
    # the routes ROADMAP item 5 ported run, each on its route: 13 wires on
    # sel_apply_gates and the PyTorch amplitude-damping pass, a CNOT ring
    # past the per-layer route's 8 wires on the grouped chain
    ({"encode": "ry", "noise": _DAMPING, "n_traj": 4, "wires": 13},
     "item 5"),
    ({"imprimitive": "cnot", "wires": 9}, "item 5"),
])
def test_reupload_block_unported_options_raise(kwargs, item):
    kwargs = dict(kwargs)
    wires = kwargs.pop("wires", 3)
    x = torch.zeros(2, wires)
    w = torch.zeros(1, 2, wires, 3)
    if item is None:
        clean = tengine.reupload_block(x, w)
        assert torch.equal(tengine.reupload_block(x, w, **kwargs), clean)
    elif item == "random source":
        with pytest.raises(ValueError, match=item):
            tengine.reupload_block(x, w, **kwargs)
        out = tengine.reupload_block(
            x, w, traj_rng=torch.Generator().manual_seed(0), **kwargs)
        assert out.shape == (2, 8) and torch.isfinite(out).all()
    elif item == "item 11":
        from qiddm_tpu_torch.parallel import distributed, make_mesh

        rng = _rng(11)
        x = torch.as_tensor(rng.uniform(size=(2, wires)), dtype=torch.float32)
        w = torch.as_tensor(rng.normal(size=(1, 2, wires, 3)),
                            dtype=torch.float32)
        mesh = make_mesh(1, device="cpu")
        try:
            for readout in ("probs", "expvalz"):
                got = tengine.reupload_block(x, w, readout=readout,
                                             mesh=mesh)
                want = tengine.reupload_block(x, w, readout=readout)
                assert got.shape == want.shape
                assert torch.allclose(got, want, atol=1e-6)
        finally:
            distributed.shutdown()
    elif item == "item 5":
        tengine.reset_route_calls()
        out = tengine.reupload_block(
            x, w, traj_rng=torch.Generator().manual_seed(0), **kwargs)
        assert out.shape == (2, 2**wires) and torch.isfinite(out).all()
        want = ({"gates": 1, "amp_xla": 1} if "noise" in kwargs
                else {"wide": 1})
        assert {k: v for k, v in tengine.ROUTE_CALLS.items() if v} == want


def test_reupload_block_ry_runs_the_ry_chain_below_2_to_the_w(monkeypatch):
    from qiddm_tpu_torch.sim import ry_kernel

    calls = []
    real = ry_kernel._RyChain.apply

    def spy(*a):
        calls.append(a[2:])
        return real(*a)

    monkeypatch.setattr(ry_kernel._RyChain, "apply", spy)
    w = torch.rand(2, 3, 4, 3)
    tsim.reupload_block(torch.rand(5, 4), w, encode="ry")
    tsim.reupload_block(torch.rand(16, 4), w, encode="ry")  # composed
    assert calls == [(3, 4)]
    with pytest.raises(ValueError, match="unknown encode"):
        tsim.reupload_block(torch.rand(5, 4), w, encode="rx")


def test_ry_pieces_match_jax():
    rng = _rng(6)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tsim.ry_matrix(torch.as_tensor(x)).numpy(),
        np.asarray(jsim.ry_matrix(jnp.asarray(x))), atol=CLOSED_FORM_TOL)
    np.testing.assert_allclose(
        tsv.ry_product_state(torch.as_tensor(x), 3).numpy(),
        np.asarray(jsv.ry_product_state(jnp.asarray(x), 3)),
        atol=CLOSED_FORM_TOL)
    st = rng.normal(size=(2, 5, 8)).astype(np.float32)
    states = st[0] + 1j * st[1]
    np.testing.assert_allclose(
        tsv.apply_ry_all(torch.as_tensor(states), torch.as_tensor(x)).numpy(),
        np.asarray(jsv.apply_ry_all(jnp.asarray(states), jnp.asarray(x))),
        atol=CLOSED_FORM_TOL)
    gate = tsim.ry_matrix(torch.as_tensor(x[0, 0]))
    np.testing.assert_allclose(
        tsv.apply_1q(torch.as_tensor(states), gate, 1, 3).numpy(),
        np.asarray(jsv.apply_1q(jnp.asarray(states),
                                jnp.asarray(gate.numpy()), 1, 3)),
        atol=CLOSED_FORM_TOL)


def test_x64_switch_runs_composed_route_in_complex128():
    """complex128 runs the composed route at batch >= 2^w, the per-layer
    unitaries below it up to 8 wires and the grouped chain from 9 (the JAX
    package's TPU route); all agree with the complex64 result."""
    from qiddm_tpu_torch import config

    rng = _rng(5)
    x = torch.as_tensor(rng.normal(size=(20, 4)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(3, 2, 4, 3)) * 0.4,
                        dtype=torch.float32)
    x9 = torch.as_tensor(rng.normal(size=(5, 9)), dtype=torch.float32)
    w9 = torch.as_tensor(rng.normal(size=(2, 2, 9, 3)) * 0.4,
                         dtype=torch.float32)
    want = tsim.reupload_block(x, w, readout="probs")
    want_small = tsim.reupload_block(x[:5], w, readout="probs")
    want9 = tsim.reupload_block(x9, w9, readout="probs")
    config.enable_x64(True)
    try:
        assert config.complex_dtype() == torch.complex128
        assert config.real_dtype() == torch.float64
        got = tsim.reupload_block(x, w, readout="probs")
        got_small = tsim.reupload_block(x[:5], w, readout="probs")
        tengine.reset_route_calls()
        got9 = tsim.reupload_block(x9, w9, readout="probs")
        assert tengine.ROUTE_CALLS["wide"] == 1
    finally:
        config.enable_x64(False)
    assert got.dtype == got_small.dtype == got9.dtype == torch.float64
    for g, want_ in ((got, want), (got_small, want_small), (got9, want9)):
        np.testing.assert_allclose(g.numpy(), want_.numpy(), atol=CHAIN_TOL)
