"""AOT serving artifacts in qiddm_tpu_torch (qiddm_tpu_torch/export.py),
the counterpart of tests/test_export.py.

* The cases of tests/test_export.py on ``QIDDM_LL_noise(64, 4, 2, 1, 0)``
  at 8x8: round trip, grid mode, hot swap, the trajectory rejection, the
  CLI round trip, a bundle at n in {0, 1, 2, 3, 4, 5, 9}, the pickle-free
  blob, the bundle CLI, the decoder's hardening, the empty-batch contract
  and ``--from-export`` refusing ``--export-batches``.
* Parity: a loaded port artifact against the JAX package's
  ``load_sampler(export_sampler(...))`` on the same numpy ``first_x`` and
  the same weights (carried across with ``load_jax_variables``) within
  1e-5, for QIDDM_LL_noise, a small QNN_noise, a small QIDDM_PL_noise1
  (one iteration: the PCA refit's float32 drift grows with each), a
  dm-noise model and the 11-wire QIDDM_LL_noise(64, 11, 2, 2) (one
  iteration); and against the port's live sampler within 1e-6, since the
  program calls the same operators in the same order.
* ``torch.library.opcheck`` on each of the seven forward operators at
  small CPU shapes.
* A ``("cuda",)`` artifact emitted on this CPU host: its graph's nodes on
  cuda, the kernel operators in it, and no CPU run of it.
* A crafted artifact whose payload is a code-running pickle, or whose graph
  calls something other than a tensor operator: the loader raises and the
  code does not run.
"""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import export as jexport
from qiddm_tpu import nn as jnn
from qiddm_tpu.cli import common as jcommon
from qiddm_tpu.diffusion import Diffusion as JDiffusion
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch import export as texport
from qiddm_tpu_torch import nn as tnn
from qiddm_tpu_torch.cli import common as tcommon
from qiddm_tpu_torch.cli import sample as tsample
from qiddm_tpu_torch.diffusion import Diffusion as TDiffusion
from qiddm_tpu_torch.sim import gate_kernel, ops, sel_kernel, wide_kernel
from qiddm_tpu_torch.sim.gates import rot_matrix

JAX_TOL = 1e-5
LIVE_TOL = 1e-6
BASE = ["--model", "QIDDM_LL_noise", "64", "4", "2", "1", "--img_size", "8",
        "--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread per test process: a thread pool in each oversubscribes
    the cores beside the other workers. One thread gives the same
    results."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _diff(seed=0):
    net = tnn.QIDDM_LL_noise(64, 4, 2, 1, 0, seed=seed, device="cpu")
    return TDiffusion(net=net, prediction_goal="data", shape=(8, 8)).eval()


def _x(n, seed=1, side=8):
    return torch.as_tensor(
        (np.random.default_rng(seed).uniform(size=(n, 1, side, side)) * 0.75
         + 0.5).astype(np.float32))


def _live(diff, x, iters):
    return diff.sample_fn(x, iters, only_last=True)


@pytest.fixture(scope="module")
def single():
    diff = _diff(seed=7)
    return diff, texport.export_sampler(diff, batch=5, n_iters=3)


@pytest.fixture(scope="module")
def bundle():
    diff = _diff(seed=11)
    blob = texport.export_sampler_bundle(diff, batches=[2, 4], n_iters=3)
    return diff, blob, texport.load_sampler_bundle(blob)


# --- the cases of tests/test_export.py -----------------------------------------

def test_export_roundtrip_matches_live_sampler(single):
    diff, blob = single
    assert isinstance(blob, bytes) and blob[:4] == b"QTA1"
    fn = texport.load_sampler(blob)
    x = _x(5)
    got = fn(x)
    assert got.shape == (5, 1, 8, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _live(diff, x, 3).numpy(),
                               rtol=0, atol=LIVE_TOL)


def test_export_is_self_contained_grid_mode():
    """only_last=False emits the reference's stacked grid; the loaded
    callable needs no model state: later changes to the live weights do
    not reach it."""
    diff = _diff(seed=3)
    blob = texport.export_sampler(diff, batch=2, n_iters=3, only_last=False)
    x = _x(2, seed=2)
    want = diff.sample_fn(x, 3).numpy()
    with torch.no_grad():
        for p in diff.net.parameters():
            p.zero_()
    got = texport.load_sampler(blob)(x).numpy()
    assert got.shape == (4 * 8, 2 * 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=LIVE_TOL)


def test_export_cross_platform_cuda_artifact():
    """A CPU host emits the card's artifact: the graph's nodes sit on cuda
    and call the kernel operators; this host cannot run it, and says so
    instead of running it on the CPU."""
    diff = _diff()
    blob = texport.export_sampler(diff, batch=2, n_iters=2,
                                  platforms=("cuda",))
    assert texport.artifact_device(blob).type == "cuda"
    header, rest = texport._unpack(blob)
    _, prog = texport._split_var_blob(header, rest)
    ep, device = texport._read_program(prog, device="cpu")
    assert device.type == "cuda"
    devices = {n.meta["val"].device.type for n in ep.graph.nodes
               if torch.is_tensor(n.meta.get("val"))}
    assert devices == {"cuda"}
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert "qiddm.gate_chain.default" in targets
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            texport.load_sampler(blob)
    with pytest.raises(ValueError, match="TPU programs"):
        texport.export_sampler(diff, batch=2, n_iters=2,
                               platforms=("tpu",))


def test_export_variables_hot_swap(tmp_path):
    """Variables ride as program INPUTS, so a retrained checkpoint's tree
    (ckpt.load_checkpoint's model_state_dict, the JAX package's layout)
    hot-swaps into an existing artifact."""
    d1, d2 = _diff(seed=0), _diff(seed=5)
    blob = texport.export_sampler(d1, batch=3, n_iters=2)
    path = tckpt.save_diffusion(d2, tmp_path, 0, [0.5], 1)
    tree = tckpt.load_checkpoint(path)["model_state_dict"]
    x = _x(3, seed=4)
    got2 = texport.load_sampler(blob, variables=tree)(x)
    np.testing.assert_allclose(got2.numpy(), _live(d2, x, 2).numpy(),
                               rtol=0, atol=LIVE_TOL)
    # and without the override it still serves d1's weights
    np.testing.assert_allclose(texport.load_sampler(blob)(x).numpy(),
                               _live(d1, x, 2).numpy(), rtol=0,
                               atol=LIVE_TOL)
    # a tree of another model does not fit the program's inputs
    tree.pop("params")
    with pytest.raises(ValueError, match="no leaf"):
        texport.load_sampler(blob, variables=tree)


def test_export_rejects_trajectory_models():
    net = tnn.QIDDM_LL_noise(64, 4, 2, 1, 1, seed=0, device="cpu")
    net = tcommon.with_noise(net, 1, 0.05, noise_trajectories=16)
    diff = TDiffusion(net=net, prediction_goal="data", shape=(8, 8)).eval()
    with pytest.raises(ValueError, match="trajectory"):
        texport.export_sampler(diff, batch=2, n_iters=2)
    with pytest.raises(ValueError, match="trajectory"):
        texport.export_sampler_bundle(diff, batches=[2], n_iters=2)


def test_sample_cli_export_roundtrip(tmp_path):
    diff = _diff(seed=7)
    ckpt_path = tckpt.save_diffusion(diff, tmp_path, 0, [0.5], 1)
    art = tmp_path / "sampler.qta"
    base = [*BASE, "--n", "6", "--iters", "3"]
    out = tsample.main(["--ckpt", str(ckpt_path), *base, "--export",
                        str(art)])
    assert out is None and art.exists()
    served = tsample.main(["--from-export", str(art), "--img_size", "8",
                           "--n", "6", "--device", "cpu", "--out",
                           str(tmp_path / "s"), "--format", "npz", "--seed",
                           "5"])
    direct = tsample.main(["--ckpt", str(ckpt_path), *base, "--out",
                           str(tmp_path / "d"), "--format", "npz", "--seed",
                           "5"])
    assert served.shape == (6, 1, 8, 8)
    np.testing.assert_allclose(served, direct, rtol=0, atol=LIVE_TOL)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 9])
def test_bundle_serves_any_request_size(bundle, n):
    """Bucketed bundle: smallest bucket >= n with row padding; oversize
    requests chunk through the largest bucket. Per-image denoising is
    batch-independent, so every row equals the live sampler's; n == 0
    serves an empty batch without running a program."""
    diff, blob, serve = bundle
    assert texport.is_bundle(blob)
    x = _x(n, seed=n)
    got = serve(x)
    assert got.shape == (n, 1, 8, 8) and got.dtype == torch.float32
    if n:
        np.testing.assert_allclose(got.numpy(), _live(diff, x, 3).numpy(),
                                   rtol=0, atol=JAX_TOL)


def test_bundle_and_single_loaders_cross_reject(single, bundle):
    with pytest.raises(ValueError, match="bundle"):
        texport.load_sampler_bundle(single[1])
    with pytest.raises(ValueError, match="bundle"):
        texport.load_sampler(bundle[1])
    assert not texport.is_bundle(single[1])


def test_artifacts_are_pickle_free(single):
    """Loading an artifact executes no embedded code: the variables
    segment is an npz read with allow_pickle=False and a JSON path table
    (the JAX package's tree), and the retired pickle-bearing formats and
    the JAX package's StableHLO artifacts are refused."""
    diff, blob = single
    header, rest = texport._unpack(blob)
    v = texport._vars_from_blob(header["var_paths"],
                                rest[:header["var_len"]])
    want = texport._flatten(tckpt.export_jax_variables(diff.net))
    got = texport._flatten(v)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(a, b)
    for magic in (b"QSA2", b"QSB2", b"QSB1"):
        with pytest.raises(ValueError, match="retired"):
            texport.load_sampler(magic + blob[4:])
    for magic in (b"QSA3", b"QSB3"):
        with pytest.raises(ValueError, match="StableHLO"):
            texport.load_sampler(magic + blob[4:])
        with pytest.raises(ValueError, match="StableHLO"):
            texport.load_sampler_bundle(magic + blob[4:])


def test_sample_cli_bundle_roundtrip(tmp_path):
    diff = _diff(seed=13)
    ckpt_path = tckpt.save_diffusion(diff, tmp_path, 0, [0.5], 1)
    art = tmp_path / "bundle.qtb"
    tsample.main(["--ckpt", str(ckpt_path), *BASE, "--iters", "2",
                  "--export", str(art), "--export-batches", "2,4"])
    served = tsample.main(["--from-export", str(art), "--img_size", "8",
                           "--n", "7", "--device", "cpu", "--out",
                           str(tmp_path / "s"), "--format", "npz"])
    assert np.asarray(served).shape == (7, 1, 8, 8)
    x = (torch.rand((7, 1, 8, 8), generator=torch.Generator().manual_seed(0))
         * 0.75 + 0.5)
    np.testing.assert_allclose(served, _live(diff, x, 2).numpy(), rtol=0,
                               atol=JAX_TOL)


def test_var_blob_decoder_hardening(single):
    """Decoder edge cases the round trips cannot reach: list-rooted trees,
    tuple containers, crafted headers (sequence-index DoS, out-of-range
    var_len), truncated blobs."""
    v = [np.ones((2,), np.float32), {"a": np.zeros((3,), np.float32)}]
    paths, vb = texport._var_blob(v)
    out = texport._vars_from_blob(paths, vb)
    assert isinstance(out, list) and list(out[1]) == ["a"]
    np.testing.assert_array_equal(out[0], v[0])
    np.testing.assert_array_equal(out[1]["a"], v[1]["a"])

    with pytest.raises(ValueError, match="tuple"):
        texport._var_blob({"a": (np.ones(2), np.zeros(2))})
    with pytest.raises(ValueError, match="tuple"):
        texport._var_blob([(np.ones(2),)])

    with pytest.raises(ValueError, match="out of range"):
        texport._vars_from_blob([[["s", 10**9]]], vb)
    with pytest.raises(ValueError, match="out of range"):
        texport._vars_from_blob([[["s", -3]]], vb)

    _, blob = single
    header, rest = texport._unpack(blob)
    for bad in (-1, len(rest) + 1, None):
        hb = json.dumps(dict(header, var_len=bad)).encode()
        crafted = (texport._ARTIFACT_MAGIC + struct.pack("<I", len(hb)) + hb
                   + rest)
        with pytest.raises(ValueError, match="var_len"):
            texport.load_sampler(crafted)

    with pytest.raises(ValueError, match="truncated"):
        texport._unpack(b"QTA1")
    with pytest.raises(ValueError, match="header length"):
        texport._unpack(b"QTA1" + struct.pack("<I", 10**6) + b"{}")


def test_bundle_empty_batch_contract(bundle):
    """n == 0 keeps the shape contract of n > 0: a wrong spatial tail
    raises instead of echoing back, and the output's tail and dtype are
    the program's."""
    serve = bundle[2]
    out = serve(torch.zeros((0, 1, 8, 8)))
    assert out.shape == (0, 1, 8, 8) and out.dtype == torch.float32
    with pytest.raises(ValueError, match="expects inputs"):
        serve(torch.zeros((0, 1, 16, 16)))


def test_sample_cli_from_export_rejects_export_batches(tmp_path):
    (tmp_path / "x.qtb").write_bytes(b"QTB1")
    with pytest.raises(SystemExit, match="export-batches"):
        tsample.main(["--from-export", str(tmp_path / "x.qtb"),
                      "--img_size", "8", "--device", "cpu",
                      "--export-batches", "1,8"])


@pytest.mark.parametrize("argv,match", [
    (["--model", "QIDDM_LL_noise", "64", "4", "2", "1"], "replaces"),
    (["--export", "y.qta"], "re-export"),
])
def test_sample_cli_from_export_rules(tmp_path, argv, match):
    (tmp_path / "x.qta").write_bytes(b"QTA1")
    with pytest.raises(SystemExit, match=match):
        tsample.main(["--from-export", str(tmp_path / "x.qta"),
                      "--device", "cpu", *argv])


def test_sample_cli_export_batches_needs_export(tmp_path):
    diff = _diff()
    ckpt_path = tckpt.save_diffusion(diff, tmp_path, 0, [0.5], 1)
    with pytest.raises(SystemExit, match="needs --export"):
        tsample.main(["--ckpt", str(ckpt_path), *BASE,
                      "--export-batches", "1,8"])


def test_sample_cli_refuses_another_device(tmp_path):
    """--device must name the artifact's device: a CUDA artifact is not
    served on the CPU."""
    art = tmp_path / "card.qta"
    art.write_bytes(texport.export_sampler(_diff(), batch=2, n_iters=1,
                                           platforms=("cuda",)))
    with pytest.raises(SystemExit, match="--device cuda"):
        tsample.main(["--from-export", str(art), "--img_size", "8", "--n",
                      "2", "--device", "cpu"])


def test_loaded_sampler_takes_only_its_device_and_shape(single):
    fn = texport.load_sampler(single[1])
    with pytest.raises(ValueError, match="shape"):
        fn(_x(4))
    with pytest.raises(ValueError, match="runs on cpu"):
        fn(_x(5).to("meta"))


# --- parity against the JAX package's artifacts ------------------------------

def _family(name):
    """(JAX net, port net, first_x batch, iterations) at small sizes."""
    if name == "QIDDM_LL_noise":
        args, batch, iters = (64, 4, 2, 1, 0), 5, 3
    elif name == "QNN_noise":
        args, batch, iters = (64, 4, 2), 5, 2
    elif name == "QIDDM_PL_noise1":
        args, batch, iters = (64, 4, 2, 2), 6, 1
    elif name == "dm":
        args, batch, iters = (64, 4, 2, 1, 0), 2, 1
    else:  # the 11-wire model: the wide chain's operator
        args, batch, iters = (64, 11, 2, 2), 2, 1
    cls = "QIDDM_LL_noise" if name in ("dm", "wide") else name
    jnet = getattr(jnn, cls)(*args, seed=9)
    tnet = getattr(tnn, cls)(*args, device="cpu")
    tckpt.load_jax_variables(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.variables))
    if name == "dm":
        jnet = jcommon.with_noise(jnet, 2, 0.05)
        tnet = tcommon.with_noise(tnet, 2, 0.05)
    return jnet, tnet, batch, iters


@pytest.mark.parametrize("name,op", [
    ("QIDDM_LL_noise", "gate_chain"), ("QNN_noise", "sel_chain"),
    ("QIDDM_PL_noise1", "ry_chain"), ("dm", "dm_chain"),
    ("wide", "wide_chain")])
def test_artifact_matches_jax_and_the_live_sampler(name, op):
    jnet, tnet, batch, iters = _family(name)
    first_x = (np.random.default_rng(3).uniform(size=(batch, 1, 8, 8))
               * 0.75 + 0.5).astype(np.float32)
    jdiff = JDiffusion(net=jnet, prediction_goal="data", shape=(8, 8)).eval()
    want = np.asarray(jexport.load_sampler(jexport.export_sampler(
        jdiff, batch=batch, n_iters=iters))(jnp.asarray(first_x)))
    tdiff = TDiffusion(net=tnet, prediction_goal="data", shape=(8, 8)).eval()
    blob = texport.export_sampler(tdiff, batch=batch, n_iters=iters)
    header, rest = texport._unpack(blob)
    ep, _ = texport._read_program(texport._split_var_blob(header, rest)[1])
    assert f"qiddm.{op}.default" in {str(n.target) for n in ep.graph.nodes}
    x = torch.as_tensor(first_x)
    got = texport.load_sampler(blob)(x).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
    np.testing.assert_allclose(got, _live(tdiff, x, iters).numpy(), rtol=0,
                               atol=LIVE_TOL)


# --- the operators -------------------------------------------------------------

def _op_args(name):
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    w, B, k = 3, 4, 2
    d = 2**w
    angles = rnd(2 * k, w, 3)
    mats = rot_matrix(angles[..., 0], angles[..., 1], angles[..., 2])
    g8 = gate_kernel._to_g8(mats)
    if name == "gate_chain":
        return (rnd(d, B), rnd(d, B), g8, k, w)
    if name == "ry_chain":
        return (rnd(2 * w, B), g8, k, w)
    if name == "sel_chain":
        return (rnd(d, B), rnd(d, B), g8, w, "cnot")
    if name == "dm_chain":
        enc = torch.polar(torch.ones(B, d), rnd(B, d))
        return (enc, g8, torch.tensor(0.1), 0.0, k, w, 1, False)
    if name in ("wide_chain", "wide_mono"):
        gplanes = list(wide_kernel._planes_of(wide_kernel.group_gates(
            mats, wide_kernel.group_sizes(w))))
        return (rnd(d, B), rnd(d, B), gplanes, k, w)
    return (rnd(d, B), rnd(d, B), rnd(2 * k, d, d), rnd(2 * k, d, d), k)


@pytest.mark.parametrize("name", sorted(ops.OPS))
def test_operator_passes_opcheck(name):
    """Schema, fake implementation, dispatch: ``torch.library.opcheck``
    at small CPU shapes, and the CPU implementation is the plain version."""
    op, args = ops.OPS[name], _op_args(name)
    torch.library.opcheck(op, args)
    out = op(*args)
    if name == "gate_chain":
        want = gate_kernel._chain_plain(
            *args[:3], gate_kernel._sign_planes_on(2, 3, torch.device("cpu")),
            2, 3)
    elif name == "sel_chain":
        want = sel_kernel._sel_plain(*args)
    else:
        return
    for a, b in zip(out, want):
        assert torch.equal(a, b)


# --- a crafted artifact -------------------------------------------------------

class _Payload:
    """Unpickling this runs code: it writes the marker file."""

    def __init__(self, marker):
        self.marker = str(marker)

    def __reduce__(self):
        return (exec, (f"open({self.marker!r}, 'w').write('ran')",))


def _with_program(blob, segment):
    header, rest = texport._unpack(blob)
    vb, _ = texport._split_var_blob(header, rest)
    return texport._pack(texport._ARTIFACT_MAGIC, header, vb, segment)


def test_crafted_pickle_never_runs(single, tmp_path):
    """A program segment (or a variables blob) whose tensor payload is a
    code-running pickle, and a graph that calls ``torch.load`` or carries
    guard code: the loader raises, and the code does not run."""
    import io

    marker = tmp_path / "ran"
    evil = np.array([_Payload(marker)], dtype=object)
    buf = io.BytesIO()
    np.savez(buf, c0=evil)
    _, blob = single
    header, rest = texport._unpack(blob)
    vb, prog = texport._split_var_blob(header, rest)
    pheader, prest = texport._unpack(prog)
    graph = prest[:pheader["graph_len"]]
    crafted = texport._pack(texport._PROGRAM_MAGIC,
                            dict(pheader, constants=["lifted"], on_host=[False]), graph,
                            buf.getvalue())
    with pytest.raises(ValueError, match="plain npz"):
        texport.load_sampler(_with_program(blob, crafted))
    # the same payload as the variables
    buf = io.BytesIO()
    np.savez(buf, a0=evil)
    hb = dict(header, var_len=len(buf.getvalue()))
    with pytest.raises(ValueError, match="allow_pickle"):
        texport.load_sampler(texport._pack(texport._ARTIFACT_MAGIC, hb,
                                           buf.getvalue(), prog))
    # torch.save's pickle where the constants npz belongs
    buf = io.BytesIO()
    torch.save({"lifted": evil}, buf)
    crafted = texport._pack(texport._PROGRAM_MAGIC,
                            dict(pheader, constants=["lifted"], on_host=[False]), graph,
                            buf.getvalue())
    with pytest.raises(ValueError, match="plain npz"):
        texport.load_sampler(_with_program(blob, crafted))
    # a graph node that calls torch.load, and guard code
    g = json.loads(graph)
    node = g["graph_module"]["graph"]["nodes"][0]
    for bad in (dict(g, guards_code=["__import__('os')"]),):
        seg = json.dumps(bad).encode()
        with pytest.raises(ValueError, match="guard code"):
            texport.load_sampler(_with_program(blob, texport._pack(
                texport._PROGRAM_MAGIC, dict(pheader, graph_len=len(seg)),
                seg, prest[pheader["graph_len"]:])))
    node["target"] = "torch.load"
    seg = json.dumps(g).encode()
    with pytest.raises(ValueError, match="torch.load"):
        texport.load_sampler(_with_program(blob, texport._pack(
            texport._PROGRAM_MAGIC, dict(pheader, graph_len=len(seg)), seg,
            prest[pheader["graph_len"]:])))
    assert not marker.exists()
