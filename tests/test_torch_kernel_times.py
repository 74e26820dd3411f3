"""The device-time script of kernels #7, #13, #14, #1, #3, #2, #4, #5, #6,
P2, P3 and P5
(``qiddm_tpu_torch/tools/kernel_times.py``) on the CPU, at small shapes:
its cases, its output line and the library formulation of the unitary
chain against the chain. On the card it times the kernels; here the
plain versions run and nothing is launched."""

import json

import numpy as np
import pytest
import torch

from qiddm_tpu_torch.sim import unitary_kernel
from qiddm_tpu_torch.sim.sel import sel_layer_unitaries
from qiddm_tpu_torch.sim.statevector import rz_phase_planes
from qiddm_tpu_torch.tools import kernel_times


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(kernel_times, "AMP_SHAPES", ((3, 5), (2, 4)))
    monkeypatch.setattr(kernel_times, "UNITARY_SHAPES", ((3, 4, 2, 2),))
    monkeypatch.setattr(kernel_times, "GATE_FWD_SHAPES",
                        ((3, 3, 4, 2), (8, 1, 2, 2)))
    monkeypatch.setattr(kernel_times, "RY_FWD_SHAPES", ((9, 2, 4, 2),))
    monkeypatch.setattr(kernel_times, "GATE_BWD_SHAPES",
                        ((3, 5, 4, 2), (1, 2, 2, 2)))
    monkeypatch.setattr(kernel_times, "RY_BWD_SHAPES", ((2, 3, 4, 2),))
    monkeypatch.setattr(kernel_times, "SEL_FWD_SHAPES",
                        ((3, 2, 3, "cz"), (2, 3, 2, "cnot")))
    monkeypatch.setattr(kernel_times, "SEL_BWD_SHAPES", ((3, 2, 3, "cnot"),))
    monkeypatch.setattr(kernel_times, "TRANSPOSE_SHAPES", ((32, 64, 3),))
    monkeypatch.setattr(kernel_times, "RESHAPE_SHAPES", ((5, 7, 2),))
    monkeypatch.setattr(kernel_times, "MATMUL2_SHAPES", ((16, 64, 3),))


def test_main_on_the_cpu_prints_every_case(small, capsys):
    out = kernel_times.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert out["device"] == "cpu" and out["card"] is None
    assert out["package"].endswith("qiddm_tpu_torch/__init__.py")
    assert sorted(out["times_ms"]) == sorted([
        "amp_damp w=3 N=5", "amp_damp w=2 N=4",
        "unitary_chain w=3 B=4 L*k=4", "library_unitary w=3 B=4 L*k=4",
        "unitary_chain_bwd w=3 B=4 L*k=4",
        "transpose_probe (32, 64) x 3", "reshape_probe (5, 7) x 2",
        "matmul2_probe (16, 16) @ (16, 64) x 3",
        "gate_chain_fwd w=3 B=3 L*k=4", "gate_chain_fwd w=8 B=1 L*k=2",
        "ry_chain_fwd w=9 B=2 L*k=4",
        "gate_chain_bwd w=3 B=5 L*k=4", "gate_chain_bwd w=1 B=2 L*k=2",
        "ry_chain_bwd w=2 B=3 L*k=4",
        "sel_chain_fwd w=3 B=2 depth=3 cz",
        "sel_chain_fwd w=2 B=3 depth=2 cnot",
        "sel_chain_bwd w=3 B=2 depth=3 cnot"])
    assert all(t > 0 for t in out["times_ms"].values())
    assert out["launches"] == {"amp_damp": 0, "unitary": 0,
                               "unitary_bwd": 0, "transpose": 0,
                               "reshape": 0, "matmul2": 0, "gate": 0,
                               "ry": 0, "gate_bwd": 0, "ry_bwd": 0,
                               "sel": 0, "sel_bwd": 0}
    # the profiled durations and the training step's profile are the card's
    assert out["kernel_ms"] == {} and out["call_device_ms"] == {}
    assert "qnn_step" not in out


@pytest.mark.parametrize("ring", ["cz", "cnot"])
def test_library_formulation_is_the_chain(ring):
    rng = np.random.default_rng(4)
    w, b, L, k = 4, 6, 3, 2
    weights = torch.as_tensor(rng.normal(size=(L, k, w, 3)) * 0.4,
                              dtype=torch.float32)
    pr, pi = rz_phase_planes(torch.as_tensor(
        rng.normal(size=(b, w)), dtype=torch.float32), w)
    lus = sel_layer_unitaries(weights, ring).reshape(L * k, 2**w, 2**w)
    got = kernel_times._library_unitary(torch.complex(pr, pi), lus, k)
    sr, si = unitary_kernel.unitary_chain_planes_plain(
        pr, pi, lus.real.contiguous(), lus.imag.contiguous(), k)
    assert (got.real - sr).abs().max().item() <= 1e-6
    assert (got.imag - si).abs().max().item() <= 1e-6


def test_no_card_without_cuda_refuses():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        kernel_times.main([])
