"""The Monte-Carlo trajectory noise backend of qiddm_tpu_torch against
qiddm_tpu's on the CPU (``sim/trajectories.py`` in both packages).

JAX keys and torch generators draw different numbers, so every parity case
injects the JAX package's draws into the port through ``ReplayDraws``: per
application point ``jax.random.uniform(key_l, (w, N))`` for amplitude
damping and ``jax.random.categorical(key_l, log p, shape=(w, N))`` for the
Pauli kinds, with the keys split as the JAX functions split them. With the
draws injected the two follow the same realization, so parity is per
realization.

Tolerances:
* one channel application on unit-norm float32 states: <= 1e-6 (the sign
  plane and the Pauli gates are exact; amplitude damping renormalizes by a
  float32 rsqrt);
* the amplitude-damping twin against ``_amp_damp_xla`` and the Pallas
  kernel in interpret mode: <= 2e-6 in values; gradients with respect to
  the state <= 5e-6, to the strength rtol 2e-4, as
  tests/test_trajectories.py holds the JAX kernel to its twin;
* circuits (probabilities and Z-expectations, means over trajectories):
  <= 1e-5, a few float32 layers at up to 12 wires;
* statistical checks against the port's exact density-matrix backend:
  5 * 0.5 / sqrt(n_traj), five standard deviations of a mean of n_traj
  values in [0, 1], with fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu.sim import engine as jengine
from qiddm_tpu.sim import trajectories as jtraj
from qiddm_tpu_torch.sim import amp_damp_kernel
from qiddm_tpu_torch.sim import density as tdm
from qiddm_tpu_torch.sim import engine as tengine
from qiddm_tpu_torch.sim import statevector as tsv
from qiddm_tpu_torch.sim import trajectories as ttraj

KINDS = ["amplitude_damping", "depolarizing", "phase_damping"]
STRENGTH = {"amplitude_damping": 0.3, "depolarizing": 0.2,
            "phase_damping": 0.35}
CHANNEL_TOL = 1e-6
TWIN_TOL = 2e-6
CIRCUIT_TOL = 1e-5


def _tol(n_traj):
    return 5 * 0.5 / np.sqrt(n_traj)


def _states(w, n, seed):
    rng = np.random.default_rng(seed)
    st = rng.normal(size=(n, 2**w)) + 1j * rng.normal(size=(n, 2**w))
    return (st / np.linalg.norm(st, axis=1, keepdims=True)).astype(
        np.complex64)


def _jax_draw(key, kind, strength, w, n):
    """The draw the JAX ``apply_channel_trajectory`` takes from ``key``."""
    if kind == "amplitude_damping":
        return np.asarray(jax.random.uniform(key, (w, n)))
    p, _ = jtraj._pauli_mixture(kind, strength)
    return np.asarray(jax.random.categorical(
        key, jnp.log(jnp.maximum(p, 1e-30)), shape=(w, n)))


@pytest.mark.parametrize("w", [1, 3, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_channel_matches_jax_with_its_draws(kind, w):
    n, s = 6, STRENGTH[kind]
    st = _states(w, n, w)
    key = jax.random.PRNGKey(10 + w)
    want = np.asarray(jtraj.apply_channel_trajectory(jnp.asarray(st), kind,
                                                     s, key))
    draws = ttraj.ReplayDraws([_jax_draw(key, kind, s, w, n)])
    got = ttraj.apply_channel_trajectory(torch.as_tensor(st), kind, s, draws)
    np.testing.assert_allclose(got.numpy(), want, atol=CHANNEL_TOL)
    norms = tsv.probs(got).sum(dim=1).numpy()
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)


@pytest.mark.parametrize("w,n", [(4, 3), (8, 4)])
def test_amp_damp_twin_matches_jax_twin_and_pallas_interpret(w, n):
    rng = np.random.default_rng(20 + w)
    st = _states(w, n, 30 + w)
    u = rng.uniform(size=(w, n)).astype(np.float32)
    g = np.float32(0.3)
    want_xla = np.asarray(jtraj._amp_damp_xla(jnp.asarray(st), jnp.asarray(u),
                                              g))
    want_kernel = np.asarray(jtraj._amp_damp_fused(
        jnp.asarray(st), jnp.asarray(u), g, 64, True))
    got, picks = amp_damp_kernel.amp_damp_plain(torch.as_tensor(st),
                                                torch.as_tensor(u), float(g))
    np.testing.assert_allclose(got.numpy(), want_xla, atol=TWIN_TOL)
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=TWIN_TOL)
    assert picks.shape == (w, n) and picks.dtype == torch.uint8

    # gradients with respect to the state (its real and imaginary parts)
    # and the strength, against jax.grad of the same weighted readout
    wgt = np.arange(2**w) / 2**w

    def jloss(re, im, gg):
        out = jtraj._amp_damp_xla(re + 1j * im, jnp.asarray(u), gg)
        return jnp.sum(jnp.abs(out) ** 2 * wgt)

    jre, jim, jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(st.real), jnp.asarray(st.imag), g)
    re = torch.as_tensor(st.real.copy()).requires_grad_(True)
    im = torch.as_tensor(st.imag.copy()).requires_grad_(True)
    gg = torch.tensor(0.3).requires_grad_(True)
    out, _ = amp_damp_kernel.amp_damp(torch.complex(re, im),
                                      torch.as_tensor(u), gg)
    (out.abs() ** 2 * torch.as_tensor(wgt, dtype=torch.float32)).sum(
    ).backward()
    np.testing.assert_allclose(re.grad.numpy(), np.asarray(jre), atol=5e-6)
    np.testing.assert_allclose(im.grad.numpy(), np.asarray(jim), atol=5e-6)
    np.testing.assert_allclose(gg.grad.item(), float(jg), rtol=2e-4)


# (wires, encode, readout, placement, kind): the three encodes, both
# readouts and both placements at 3 wires (composed unitaries: N = 8 >= 8)
# and at 11 wires (L = 1, b = 2, n_traj = 4: the SEL-chain route)
BLOCK_CASES = [
    (3, "rz", "probs", "encode", "amplitude_damping"),
    (3, "rz_halfpi", "expvalz", "encode", "depolarizing"),
    (3, "ry", "probs", "encode", "phase_damping"),
    (3, "rz", "expvalz", "end", "amplitude_damping"),
    (3, "ry", "expvalz", "end", "depolarizing"),
    (4, "ry", "probs", "encode", "amplitude_damping"),
    (11, "rz", "expvalz", "encode", "amplitude_damping"),
    (11, "rz_halfpi", "probs", "encode", "depolarizing"),
    (11, "ry", "probs", "end", "phase_damping"),
    (11, "ry", "expvalz", "encode", "amplitude_damping"),
]


def _block_draws(key, kind, strength, placement, L, w, n):
    """The JAX block's draws: ``split(key, L + 1)``, layer l's key after
    each encode, the last at the end."""
    keys = jax.random.split(key, L + 1)
    at = range(L) if placement == "encode" else [L]
    return [_jax_draw(keys[i], kind, strength, w, n) for i in at]


@pytest.mark.parametrize("w,encode,readout,placement,kind", BLOCK_CASES)
def test_reupload_block_matches_jax_with_its_draws(w, encode, readout,
                                                   placement, kind):
    rng = np.random.default_rng(w)
    L = 2 if w < 11 else 1
    b, n_traj, s = 2, 4, STRENGTH[kind]
    x = rng.normal(size=(b, w)).astype(np.float32)
    wq = (rng.normal(size=(L, 2, w, 3)) * 0.4).astype(np.float32)
    key = jax.random.PRNGKey(w + len(encode))
    want = np.asarray(jengine.reupload_block(
        jnp.asarray(x), jnp.asarray(wq), encode=encode, readout=readout,
        noise=jengine.NoiseModel(kind, s, placement), n_traj=n_traj,
        traj_key=key))
    draws = ttraj.ReplayDraws(_block_draws(key, kind, s, placement, L, w,
                                           n_traj * b))
    got = tengine.reupload_block(
        torch.as_tensor(x), torch.as_tensor(wq), encode=encode,
        readout=readout, noise=tengine.NoiseModel(kind, s, placement),
        n_traj=n_traj, traj_rng=draws)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=CIRCUIT_TOL)


@pytest.mark.parametrize("w,encode,placement,kind", [
    (12, "rz", "encode", "amplitude_damping"),
    (12, "ry", "end", "depolarizing"),
    (3, "ry", "end", "amplitude_damping"),
])
def test_qnn_circuit_matches_jax_with_its_draws(w, encode, placement, kind):
    rng = np.random.default_rng(40 + w)
    b, n_traj, s = 2, 4, STRENGTH[kind]
    x = rng.normal(size=(b, w)).astype(np.float32)
    wq = (rng.normal(size=(3, w, 3)) * 0.4).astype(np.float32)
    key = jax.random.PRNGKey(7)
    imprimitive = "cz" if encode == "rz" else "cnot"
    readout = "expvalz" if encode == "rz" else "probs"
    want = np.asarray(jengine.qnn_circuit(
        jnp.asarray(x), jnp.asarray(wq), encode=encode,
        imprimitive=imprimitive, readout=readout,
        noise=jengine.NoiseModel(kind, s, placement), n_traj=n_traj,
        traj_key=key))
    k_enc, k_end = jax.random.split(key)
    draw = _jax_draw(k_enc if placement == "encode" else k_end, kind, s, w,
                     n_traj * b)
    got = tengine.qnn_circuit(
        torch.as_tensor(x), torch.as_tensor(wq), encode=encode,
        imprimitive=imprimitive, readout=readout,
        noise=tengine.NoiseModel(kind, s, placement), n_traj=n_traj,
        traj_rng=ttraj.ReplayDraws([draw]))
    np.testing.assert_allclose(got.numpy(), want, atol=CIRCUIT_TOL)


@pytest.mark.parametrize("wires,batch,kind", [(4, 2, "amplitude_damping"),
                                              (3, 3, "phase_damping")])
def test_qdense_circuit_matches_jax_with_its_draws(wires, batch, kind):
    rng = np.random.default_rng(50 + wires)
    n_traj, s = 3, STRENGTH[kind]
    x = rng.uniform(size=(batch, 2**wires - 3)).astype(np.float32)
    wq = (rng.normal(size=(4, wires, 3)) * 0.4).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jengine.qdense_circuit(
        jnp.asarray(x), jnp.asarray(wq), wires=wires,
        noise=jengine.NoiseModel(kind, s, "end"), n_traj=n_traj,
        traj_key=key))
    got = tengine.qdense_circuit(
        torch.as_tensor(x), torch.as_tensor(wq), wires=wires,
        noise=tengine.NoiseModel(kind, s, "end"), n_traj=n_traj,
        traj_rng=ttraj.ReplayDraws(
            [_jax_draw(key, kind, s, wires, n_traj * batch)]))
    np.testing.assert_allclose(got.numpy(), want, atol=CIRCUIT_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_channel_converges_to_the_dm_backend(kind):
    w, b, n_traj, s = 3, 2, 4000, STRENGTH[kind]
    st = torch.as_tensor(_states(w, b, 60))
    want = tdm.probs(tdm.apply_channel_all_wires(tdm.from_statevector(st),
                                                 kind, s))
    out = ttraj.apply_channel_trajectory(
        ttraj._tile_traj(st, n_traj), kind, s,
        torch.Generator().manual_seed(1))
    got = ttraj._mean_over_traj(tsv.probs(out), n_traj)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=_tol(n_traj))


@pytest.mark.parametrize("kind,readout,placement", [
    ("amplitude_damping", "probs", "encode"),
    ("depolarizing", "expvalz", "encode"),
    ("phase_damping", "probs", "end"),
])
def test_reupload_block_converges_to_the_dm_backend(kind, readout, placement):
    rng = np.random.default_rng(70)
    x = torch.as_tensor(rng.normal(size=(3, 3)), dtype=torch.float32)
    wq = torch.as_tensor(rng.normal(size=(2, 2, 3, 3)) * 0.4,
                         dtype=torch.float32)
    noise = tengine.NoiseModel(kind, STRENGTH[kind], placement)
    want = tengine.reupload_block(x, wq, noise=noise, readout=readout)
    n_traj = 4000
    got = tengine.reupload_block(x, wq, noise=noise, readout=readout,
                                 n_traj=n_traj,
                                 traj_rng=torch.Generator().manual_seed(2))
    scale = 2.0 if readout == "expvalz" else 1.0
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               atol=scale * _tol(n_traj))


@pytest.mark.parametrize("w", [3, 4])
def test_strength_zero_is_the_clean_circuit(w):
    """The trajectories (N = 6 < 2**w states) take the SEL-chain route, the
    clean block the gate chain."""
    rng = np.random.default_rng(80)
    x = torch.as_tensor(rng.normal(size=(2, w)), dtype=torch.float32)
    wq = torch.as_tensor(rng.normal(size=(1, 2, w, 3)) * 0.4,
                         dtype=torch.float32)
    clean = tengine.reupload_block(x, wq, readout="probs")
    for kind in KINDS:
        got = tengine.reupload_block(
            x, wq, readout="probs", n_traj=3,
            noise=tengine.NoiseModel(kind, 0.0, "encode"),
            traj_rng=torch.Generator().manual_seed(3))
        np.testing.assert_allclose(got.numpy(), clean.numpy(), atol=2e-6)


def test_missing_random_source_raises():
    noise = tengine.NoiseModel("depolarizing", 0.05, "encode")
    with pytest.raises(ValueError, match="random source"):
        tengine.reupload_block(torch.zeros(2, 3), torch.zeros(2, 2, 3, 3),
                               noise=noise, n_traj=8)
    with pytest.raises(ValueError, match="random source"):
        tengine.qdense_circuit(
            torch.zeros(2, 8), torch.zeros(4, 3, 3), wires=3, n_traj=8,
            noise=tengine.NoiseModel("amplitude_damping", 0.1, "end"))
    with pytest.raises(TypeError, match="torch.Generator"):
        ttraj.apply_channel_trajectory(torch.ones(1, 2, dtype=torch.complex64),
                                       "depolarizing", 0.1, 5)


def test_recorded_draws_replay_the_same_realization():
    """What a generator drew, replayed with the picks it took, gives the
    same circuit: the seam chip_smoke.py uses to hold the card to the
    CPU."""
    rng = np.random.default_rng(90)
    x = torch.as_tensor(rng.normal(size=(2, 4)), dtype=torch.float32)
    wq = torch.as_tensor(rng.normal(size=(2, 2, 4, 3)) * 0.4,
                         dtype=torch.float32)
    noise = tengine.NoiseModel("amplitude_damping", 0.4, "encode")
    rec = ttraj.RecordedDraws(torch.Generator().manual_seed(4))
    first = tengine.reupload_block(x, wq, noise=noise, n_traj=5,
                                   traj_rng=rec)
    assert len(rec.draws) == len(rec.picks) == 2
    again = tengine.reupload_block(
        x, wq, noise=noise, n_traj=5,
        traj_rng=ttraj.ReplayDraws(rec.draws, rec.picks))
    assert torch.equal(first, again)
    with pytest.raises(ValueError, match="ran out"):
        tengine.reupload_block(x, wq, noise=noise, n_traj=5,
                               traj_rng=ttraj.ReplayDraws(rec.draws[:1]))
