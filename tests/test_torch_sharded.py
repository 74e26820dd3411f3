"""The port's sharded statevector (qiddm_tpu_torch/sim/sharded.py) on 4 CPU
ranks (gloo) against the JAX package's dense simulator: the cases of
tests/test_sharded.py, with 2 of the state's bits selecting the rank.

The ranks run once, in tests/torch_mesh_worker.py (no JAX there), and
write their results; each test compares one of them here.

Tolerances (the JAX test's):
* values against the dense route: 1e-5 absolute (float32 sums in another
  order, and across ranks);
* gradients against ``jax.grad`` of the dense route, and the adjoint
  backward against autograd through the same program: 3e-5 absolute;
* the adjoint program's values against the plain program's: 1e-6;
* complex128 against the port's own dense complex128 route: 1e-12;
* trajectories against the port's dense trajectory backend on the same
  generator seed (the same branches): 1e-5.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qiddm_tpu import nn as jnn
from qiddm_tpu.sim import engine as jengine
from qiddm_tpu.sim import expval_z, probs, sel_apply_direct, zero_state
from tests.torch_mesh_worker import (
    CHANNELS,
    ENCODES,
    GRAD_CASES,
    GROUPED_CASES,
    PL_MODEL,
    READOUTS,
    RINGS,
    SEL_GRID,
    run_ranks,
    sharded_inputs,
)

VALUE_TOL, GRAD_TOL, ADJ_TOL, X64_TOL = 1e-5, 3e-5, 1e-6, 1e-12


@pytest.fixture(scope="module")
def inputs():
    return sharded_inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inputs):
    out = tmp_path_factory.mktemp("sharded")
    net = jnn.QIDDM_PL_noise1(*PL_MODEL, seed=0)
    with open(out / "pl_variables.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, dict(net.variables)),
                    f)
    results = run_ranks("sharded", out)
    return results


@pytest.fixture(scope="module")
def res(ranks):
    return ranks[0]


def _dense(x, w, **kw):
    return np.asarray(jengine.reupload_block(jnp.asarray(x), jnp.asarray(w),
                                             **kw))


def test_replicated_results_agree_on_every_rank(ranks):
    for r in ranks[1:]:
        for key in ("re/rz/cz/expvalz", "re/ry/cnot/probs", "full_val"):
            np.testing.assert_array_equal(r[key], ranks[0][key])
        np.testing.assert_array_equal(r["adj/rz/cz/auto"][0],
                                      ranks[0]["adj/rz/cz/auto"][0])


@pytest.mark.parametrize("wires,layers,ring", SEL_GRID)
def test_sharded_sel_matches_dense(res, inputs, wires, layers, ring):
    state, p, ev, bits = res[f"sel/{wires}/{layers}/{ring}"]
    assert bits == 2
    w = jnp.asarray(inputs[f"sel/{wires}/{layers}/{ring}"])
    dense = sel_apply_direct(zero_state(1, wires), w, imprimitive=ring)[0]
    np.testing.assert_allclose(state, np.asarray(dense), atol=VALUE_TOL)
    np.testing.assert_allclose(p, np.asarray(probs(dense[None]))[0],
                               atol=VALUE_TOL)
    np.testing.assert_allclose(ev, np.asarray(expval_z(dense[None]))[0],
                               atol=VALUE_TOL)


def test_sharded_norm_preserved(res):
    np.testing.assert_allclose(res["norm"], 1.0, atol=VALUE_TOL)


def test_sharded_sel_gradients_match_dense(res, inputs):
    def loss(w):
        dense = sel_apply_direct(zero_state(1, 5), w, imprimitive="cz")
        return jnp.sum(expval_z(dense) ** 2)

    want = np.asarray(jax.grad(loss)(jnp.asarray(inputs["flow_w"])))
    assert np.abs(res["flow"]).max() > 0
    np.testing.assert_allclose(res["flow"], want, atol=GRAD_TOL)


@pytest.mark.parametrize("readout", READOUTS)
@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("encode", ENCODES)
def test_sharded_reupload_matches_jax_engine(res, inputs, encode, ring,
                                             readout):
    want = _dense(inputs["re_x"], inputs["re_w"], encode=encode,
                  imprimitive=ring, readout=readout)
    np.testing.assert_allclose(res[f"re/{encode}/{ring}/{readout}"], want,
                               atol=VALUE_TOL)


@pytest.mark.parametrize("encode", ["rz", "ry"])
def test_engine_reupload_mesh_route(res, inputs, encode):
    want = _dense(inputs["re_x"][:4], inputs["re_w"], encode=encode,
                  readout="expvalz")
    np.testing.assert_allclose(res[f"route/{encode}"], want, atol=VALUE_TOL)


@pytest.mark.parametrize("encode", ["rz", "rz_halfpi"])
def test_engine_mesh_route_rot_angle_after_halfpi(res, inputs, encode):
    """The over-rotation lands after the halfpi scaling, as on the dense
    route."""
    noise = jengine.NoiseModel("rot_angle", 0.1, "encode")
    want = _dense(inputs["rot_x"], inputs["rot_w"], encode=encode,
                  readout="expvalz", noise=noise)
    np.testing.assert_allclose(res[f"rot/{encode}"], want, atol=VALUE_TOL)


@pytest.mark.parametrize("encode,ring", GRAD_CASES)
def test_sharded_adjoint_grads_match_plain_and_jax(res, inputs, encode,
                                                   ring):
    coeff = jnp.asarray(inputs["adj_c"])

    def loss(w, x):
        return jnp.sum(coeff * jengine.reupload_block(
            x, w, encode=encode, imprimitive=ring, readout="expvalz"))

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(inputs["adj_w"]),
                                           jnp.asarray(inputs["adj_x"]))
    got, plain = res[f"adj/{encode}/{ring}/auto"], res[
        f"adj/{encode}/{ring}/off"]
    for i in range(2):
        np.testing.assert_allclose(got[i], plain[i], atol=GRAD_TOL,
                                   err_msg=f"adjoint vs autograd arg{i}")
        np.testing.assert_allclose(got[i], np.asarray(want[i]),
                                   atol=GRAD_TOL,
                                   err_msg=f"adjoint vs jax.grad arg{i}")


@pytest.mark.parametrize("readout", READOUTS)
def test_sharded_adjoint_values_match_plain(res, readout):
    np.testing.assert_allclose(res[f"adjval/{readout}/auto"],
                               res[f"adjval/{readout}/off"], atol=ADJ_TOL)


def test_sharded_adjoint_halfpi_encode_grads(res, inputs):
    coeff = jnp.asarray(inputs["adj_c"])
    w = jnp.asarray(inputs["rot_w"])
    want = jax.grad(lambda xx: jnp.sum(coeff * jengine.reupload_block(
        xx, w, encode="rz_halfpi", readout="expvalz")))(
            jnp.asarray(inputs["rot_x"]))
    np.testing.assert_allclose(res["halfpi_grad"], np.asarray(want),
                               atol=GRAD_TOL)


def test_fully_sharded_statevector(res, inputs):
    """2 wires on 4 ranks: no local wire, every gate an exchange."""
    assert res["full_bits"] == 2
    x, w = jnp.asarray(inputs["full_x"]), jnp.asarray(inputs["full_w"])
    coeff = jnp.asarray(inputs["full_c"])
    np.testing.assert_allclose(
        res["full_val"], _dense(x, w, readout="expvalz"), atol=VALUE_TOL)
    want = jax.grad(lambda ww: jnp.sum(coeff * jengine.reupload_block(
        x, ww, readout="expvalz")))(w)
    np.testing.assert_allclose(res["full_grad"], np.asarray(want),
                               atol=GRAD_TOL)


@pytest.mark.parametrize("encode,ring", GROUPED_CASES)
def test_sharded_grouped_matches_perwire(res, inputs, encode, ring):
    """9 wires, 7 local in groups (4, 3), against one-wire groups
    (config.set_wide_mode("off")), adjoint on and off, and the value
    against the JAX dense route."""
    ref_val, ref_grads = res[f"grp/{encode}/{ring}/off/off"]
    for wide in ("auto", "off"):
        for adj in ("auto", "off"):
            val, grads = res[f"grp/{encode}/{ring}/{wide}/{adj}"]
            np.testing.assert_allclose(val, ref_val, rtol=1e-5, atol=1e-6)
            for i, g in enumerate(grads):
                np.testing.assert_allclose(g, ref_grads[i], atol=GRAD_TOL,
                                           err_msg=f"{wide}/{adj} arg{i}")
    want = float(jnp.sum(jnp.asarray(inputs["grp_c"]) * _dense(
        inputs["grp_x"], inputs["grp_w"], encode=encode, imprimitive=ring,
        readout="expvalz")))
    np.testing.assert_allclose(ref_val, want, rtol=1e-5, atol=1e-5)


def test_x64_sharded_path(res):
    """complex128 through the mesh keeps float64 (tests/test_misc.py's
    x64 case): against the dense complex128 route."""
    got, want = res["x64"]
    assert got.dtype == np.float64
    assert float(np.abs(got - want).max()) < X64_TOL


@pytest.mark.parametrize("readout", READOUTS)
@pytest.mark.parametrize("kind", CHANNELS)
def test_sharded_trajectories_match_dense_backend(res, kind, readout):
    """One generator seed on every rank draws the dense backend's
    branches: the trajectory estimates agree."""
    got, want = res[f"traj/{kind}/{readout}"]
    np.testing.assert_allclose(got, want, atol=VALUE_TOL)


def test_pl_noise1_module_rides_mesh(res, inputs):
    """QIDDM_PL_noise1 (RY re-upload, expval readout) through the mesh
    route equals the same module's dense forward, and the JAX module's
    with the same variables within the PCA models' 1e-4
    (tests/test_torch_pl_models.py)."""
    np.testing.assert_allclose(res["pl"], res["pl_dense"], atol=VALUE_TOL)
    net = jnn.QIDDM_PL_noise1(*PL_MODEL, seed=0)
    want = np.asarray(net(jnp.asarray(inputs["pl_x"])))
    np.testing.assert_allclose(res["pl"], want, atol=1e-4)
