"""The QASM bridge and the native engine of qiddm_tpu_torch against
qiddm_tpu's on the CPU.

* ``sim/qasm.py``: the emitted QASM text equal to the JAX package's,
  character for character; ``run_qasm`` (a complex128 torch statevector,
  here on the CPU) and ``run_qasm_native`` (the native engine on the
  host, the card's reference) within 1e-12 of the JAX package's;
  ``sample_from_qasm``'s counts equal for a seed; the same through
  ``nn/utils.py``'s bridge.
* ``native/``: every check of tests/test_native.py, each against the JAX
  package's engine, which is the same C++: the same bits.
"""

import numpy as np
import pytest
import torch

import oracle
from qiddm_tpu import native as jnative
from qiddm_tpu.nn import utils as jutils
from qiddm_tpu.sim import qasm as jqasm
from qiddm_tpu_torch import native as tnative
from qiddm_tpu_torch.nn import utils as tutils
from qiddm_tpu_torch.sim import qasm as tqasm

PROB_TOL = 1e-12

pytestmark = pytest.mark.skipif(
    not jnative.available(),
    reason="the JAX package's native engine is unavailable")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The engine's build and the statevector runs beside other test
    processes: one thread of torch, which gives the same results."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _circuit(wires, layers, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(layers, wires, 3)).astype(np.float32),
            rng.normal(size=wires).astype(np.float32))


def test_the_port_builds_its_own_engine():
    assert tnative.available(), tnative.qsim.build_error()
    lib = tnative.qsim.library_path()
    assert lib.parent.parts[-2:] == ("build", "qiddm_tpu_torch")
    assert lib.is_file()
    assert not list(lib.parent.glob(f"{lib.name}.*.tmp"))


@pytest.mark.parametrize("wires,layers,ancilla,reps",
                         [(3, 2, False, 1), (2, 1, True, 2), (5, 3, True, 3),
                          (10, 4, True, 3)])
def test_qasm_text_equals_jax(wires, layers, ancilla, reps):
    w, x = _circuit(wires, layers, wires)
    want = jqasm.circuit_to_qasm(w, wires, x)
    got = tqasm.circuit_to_qasm(torch.as_tensor(w), wires,
                                torch.as_tensor(x))
    assert got == want
    assert tqasm.circuit_to_qasm(w, wires, x) == want
    assert (tqasm.repeat_qasm(got + "\n\n", wires, ancilla, reps)
            == jqasm.repeat_qasm(want + "\n\n", wires, ancilla, reps))
    assert tutils.circuit_to_qasm(w, wires, x) == jutils.circuit_to_qasm(
        w, wires, x)
    assert (tutils.repeat_qasm(want, wires, ancilla, reps)
            == jutils.repeat_qasm(want, wires, ancilla, reps))


@pytest.mark.parametrize("wires,layers,ancilla,reps",
                         [(3, 2, False, 1), (4, 2, True, 2),
                          (10, 4, True, 3)])
def test_run_qasm_matches_jax(wires, layers, ancilla, reps):
    w, x = _circuit(wires, layers, 20 + wires)
    text = jqasm.repeat_qasm(jqasm.circuit_to_qasm(w, wires, x), wires,
                             ancilla, reps)
    want = jqasm.run_qasm(text)
    got = tqasm.run_qasm(text, device="cpu")
    assert got.dtype == torch.float64 and got.shape == (2**wires,)
    np.testing.assert_allclose(got.numpy(), want, atol=PROB_TOL, rtol=0)
    # the host reference the card's run is held to: the native engine
    np.testing.assert_allclose(tqasm.run_qasm_native(text), want,
                               atol=PROB_TOL, rtol=0)


def test_run_qasm_matches_the_oracle_and_runs_cz_and_reset():
    wires = 3
    w, x = _circuit(wires, 2, 31)
    probs = tqasm.run_qasm(tqasm.circuit_to_qasm(w, wires, x), "cpu").numpy()
    state = np.zeros(2**wires, complex)
    state[0] = 1.0
    rx = lambda t: np.array([[np.cos(t / 2), -1j * np.sin(t / 2)],
                             [-1j * np.sin(t / 2), np.cos(t / 2)]])
    for j in range(wires):
        state = oracle.embed_1q(rx(float(x[j])), j, wires) @ state
    state = oracle.sel_matrix(w.astype(np.float64), wires, "cnot") @ state
    np.testing.assert_allclose(probs, np.abs(state) ** 2, atol=1e-10)
    # cz on a non-neighbour pair, and a reset of a wire that is |1>
    text = "\n".join([
        "OPENQASM 2.0;", 'include "qelib1.inc";', "qreg q[3];", "creg c[3];",
        "ry(0.7) q[0];", "ry(1.3) q[2];", "cz q[2],q[0];", "rx(0.4) q[1];",
        f"rx({np.pi!r}) q[1];", "reset q[0];", "reset q[1];",
        "measure q[0] -> c[0];", ""])
    np.testing.assert_allclose(tqasm.run_qasm(text, "cpu").numpy(),
                               jqasm.run_qasm(text), atol=PROB_TOL, rtol=0)
    with pytest.raises(ValueError, match="unsupported QASM line"):
        tqasm.run_qasm(text.replace("cz q[2],q[0];", "h q[0];"), "cpu")
    with pytest.raises(ValueError, match="no qreg"):
        tqasm.run_qasm("rx(0.1) q[0];", "cpu")


@pytest.mark.parametrize("shots", [None, 1000, 10_000])
def test_sample_from_qasm_counts_equal_jax(shots):
    w, x = _circuit(4, 2, 41)
    text = jqasm.repeat_qasm(jqasm.circuit_to_qasm(w, 4, x), 4, True, 2)
    want = jqasm.sample_from_qasm(text, shots=shots, seed=7)
    got = tqasm.sample_from_qasm(text, shots=shots, seed=7, device="cpu")
    assert got.dtype == want.dtype
    if shots is None:
        np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)
        assert got.sum() == shots
    got = tutils.sample_from_qiskit(text, shots=shots, device="cpu")
    want = jutils.sample_from_qiskit(text, shots=shots)
    if shots is None:
        np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_sample_bit_order_is_qiskit_s():
    text = "\n".join([
        "OPENQASM 2.0;", 'include "qelib1.inc";', "qreg q[2];", "creg c[2];",
        f"rx({np.pi!r}) q[0];",
        "measure q[0] -> c[0];", "measure q[1] -> c[1];", ""])
    counts = tqasm.sample_from_qasm(text, shots=1000, seed=0, device="cpu")
    assert counts[1] == 1000  # q0=1, q1=0 -> qiskit index 0b01
    np.testing.assert_allclose(
        tqasm.sample_from_qasm(text, shots=None, device="cpu"),
        [0, 1, 0, 0], atol=1e-9)


def test_run_qasm_defaults_to_the_card():
    w, x = _circuit(2, 1, 3)
    text = tqasm.circuit_to_qasm(w, 2, x)
    if torch.cuda.is_available():
        assert tqasm.run_qasm(text).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tqasm.run_qasm(text)


# --- the native engine, against the JAX package's (the same C++) ----------

RNG = np.random.default_rng(21)


def _both(name, *args, **kw):
    return (getattr(tnative, name)(*args, **kw),
            getattr(jnative, name)(*args, **kw))


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, list):
        assert a == b
    else:
        np.testing.assert_array_equal(a, b)


def test_native_sel_matches_jax_and_the_oracle():
    wires, layers = 3, 4
    w = RNG.normal(size=(layers, wires, 3)) * 0.4
    ops, jops = _both("build_sel_ops", w, "cnot")
    _equal(ops, jops)
    out, jout = _both("statevector_run", wires, ops, want_state=True)
    _equal(out, jout)
    want = oracle.sel_matrix(w, wires, "cnot")[:, 0]
    np.testing.assert_allclose(out[2], want, atol=1e-12)


def test_native_reupload_and_amplitude_runs_match_jax():
    wires, L, k = 4, 3, 2
    w = RNG.normal(size=(L, k, wires, 3)) * 0.4
    x = RNG.normal(size=(wires,))
    for encode in ("rz", "ry", "rz_halfpi"):
        ops, jops = _both("build_reupload_ops", x, w, encode=encode,
                          imprimitive="cz")
        _equal(ops, jops)
        _equal(*_both("statevector_run", wires, ops))
    amp = oracle.amplitude_embed(np.abs(RNG.normal(size=(6,))) + 0.1, 3, 0.1)
    ops = tnative.build_sel_ops(RNG.normal(size=(5, 3, 3)) * 0.4, "cnot")
    _equal(*_both("statevector_run", 3, ops, init_amps=amp))


def test_native_density_channels_match_jax():
    wires, L, k = 3, 2, 2
    w = RNG.normal(size=(L, k, wires, 3)) * 0.4
    x = RNG.normal(size=(wires,))
    for kind, strength in [("phase_damping", 0.3),
                           ("amplitude_damping", 0.2),
                           ("depolarizing", 0.5)]:
        for placement in ("encode", "end"):
            ops, jops = _both("build_reupload_ops", x, w, noise_kind=kind,
                              noise_strength=strength,
                              noise_placement=placement)
            _equal(ops, jops)
            (probs, ev), jout = _both("density_run", wires, ops)
            _equal((probs, ev), jout)
            assert abs(probs.sum() - 1.0) < 1e-9


def test_native_rejects_channels_as_jax():
    bad = [(tnative.qsim.CH_DEPOL, 0, 0, 0.5)]
    with pytest.raises(ValueError):
        tnative.statevector_run(2, bad)
    with pytest.raises(ValueError):
        tnative.adjoint_grad(2, [(tnative.qsim.RY, 0, 0, 0.3), *bad])
    assert (tnative.qsim.RX, tnative.qsim.CNOT, tnative.qsim.CH_DEPOL) == (
        jnative.qsim.RX, jnative.qsim.CNOT, jnative.qsim.CH_DEPOL)


def test_native_sampling_matches_jax():
    probs = np.array([0.5, 0.25, 0.125, 0.125])
    counts, jcounts = _both("sample_counts", probs, shots=100_000, seed=3)
    _equal(counts, jcounts)
    assert counts.sum() == 100_000
    np.testing.assert_allclose(counts / 100_000, probs, atol=0.01)


def test_native_adjoint_grad_matches_jax():
    q = tnative.qsim
    th = RNG.normal(size=12) * 0.7
    ops = [
        (q.RY, 0, 0, th[0]), (q.RX, 1, 0, th[1]), (q.RZ, 2, 0, th[2]),
        (q.CNOT, 0, 1), (q.CZ, 1, 2),
        (q.ROT, 1, 0, th[3], th[4], th[5]),
        (q.PHASESHIFT, 2, 0, th[6]),
        (q.CNOT, 2, 0),
        (q.ROT, 0, 0, th[7], th[8], th[9]),
        (q.RY, 2, 0, th[10]), (q.RZ, 0, 0, th[11]),
    ]
    (ev, jac), jout = _both("adjoint_grad", 3, ops)
    _equal((ev, jac), jout)
    assert jac.shape == (3, 12)
    w = RNG.normal(size=(2, 2, 3, 3)) * 0.4
    ops = tnative.build_reupload_ops(RNG.normal(size=(3,)), w, encode="rz",
                                     imprimitive="cz")
    _equal(*_both("adjoint_grad", 3, ops))
