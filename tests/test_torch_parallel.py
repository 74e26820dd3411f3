"""The port's mesh layer (qiddm_tpu_torch/parallel) and the data- and
trial-parallel paths on it: one-rank meshes in this process, bit-equal to
no mesh, and 4 CPU ranks (gloo, tests/torch_mesh_worker.py) against the
one-process run, as tests/test_distributed.py and
tests/test_sweep_parallel.py hold the JAX package's.

Tolerances:
* a one-rank mesh: the same bits as no mesh (the same operations, and
  collectives over one rank);
* 4-rank data-parallel training: losses within rtol 5e-4, the parameters'
  absolute sum within rtol 1e-3 (the gradients are summed in another
  order; tests/test_distributed.py's bounds);
* 4-rank sampling, the sampling CLI: 1e-5 (each image's rows run alone,
  the same operations; float32 sums may order differently by batch);
* the 4-rank sweep against the mesh-free sweep: rtol 2e-4 (each trial
  trains alone on its rank as it would in one process).
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from qiddm_tpu import nn as jnn
from qiddm_tpu.diffusion import Diffusion as JDiffusion
from qiddm_tpu_torch import ckpt, parallel
from qiddm_tpu_torch.cli import sample as sample_cli
from qiddm_tpu_torch.diffusion import Diffusion
from qiddm_tpu_torch.nn import QIDDM_LL_noise
from qiddm_tpu_torch.parallel import NamedSharding, distributed, make_mesh
from qiddm_tpu_torch.parallel.mesh import COLLECTIVES, reset_collectives
from qiddm_tpu_torch.sweep import sweep_lr
from qiddm_tpu_torch.train import train_diffusion_scan
from tests.torch_mesh_worker import (
    CHAIN,
    CHAIN_DRAWS,
    CHAIN_VALID,
    DP,
    LL_MODEL,
    SAMPLE,
    SWEEP,
    cli_argv,
    leaves,
    parallel_inputs,
    run_ranks,
    stacked_variables,
)

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture(scope="module")
def inputs():
    return parallel_inputs()


def _chain_key(case: str):
    return jax.random.PRNGKey(11 + CHAIN[case])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results; the JAX package's draws for the CHAIN cases
    are written beside them first."""
    out = tmp_path_factory.mktemp("parallel")
    np.savez(out / CHAIN_DRAWS, **{
        case: np.asarray(0.5 + 0.2 * jax.random.normal(
            _chain_key(case), (len(CHAIN_VALID), 64)), np.float32)
        for case in CHAIN})
    return out, run_ranks("parallel", out)


@pytest.fixture
def one_rank(monkeypatch):
    """A one-rank CPU mesh in this process, its group destroyed after."""
    for key in _ENV:
        monkeypatch.delenv(key, raising=False)
    mesh = make_mesh(1, device="cpu")
    try:
        yield mesh
    finally:
        distributed.shutdown()
    assert not dist.is_initialized()


def _train(inputs, mesh):
    net = QIDDM_LL_noise(*LL_MODEL, seed=0, device="cpu")
    losses, _ = train_diffusion_scan(
        Diffusion(net, shape=(8, 8)), inputs["x"], epochs=DP["epochs"],
        batch_size=DP["batch_size"], lr=DP["lr"], T=DP["T"], key=DP["key"],
        mesh=mesh, warmup=False)
    return losses, net


def _checksum(net) -> float:
    return float(sum(p.detach().abs().sum() for p in net.parameters()))


def _sampler():
    net = QIDDM_LL_noise(*LL_MODEL, seed=0, device="cpu")
    return Diffusion(net, shape=(8, 8)).eval()


def _sweep(x, mesh=None, local_dir=None):
    return sweep_lr(lambda s: QIDDM_LL_noise(*LL_MODEL, seed=s,
                                             device="cpu"),
                    SWEEP["lrs"], x, shape=(8, 8), epochs=SWEEP["epochs"],
                    batch_size=SWEEP["batch_size"], T=SWEEP["T"],
                    sample_iters=SWEEP["sample_iters"], seed=SWEEP["seed"],
                    mesh=mesh, local_dir=local_dir, exp_name="pad")


# --- one rank, in this process -----------------------------------------------

def test_one_rank_training_is_bit_equal(inputs, one_rank):
    reset_collectives()
    got, net = _train(inputs, one_rank)
    steps = DP["epochs"] * -(-DP["n"] // DP["batch_size"])
    assert COLLECTIVES["all_reduce"] == steps  # one a step
    want, ref = _train(inputs, None)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(net.parameters(), ref.parameters()):
        assert torch.equal(a, b)


def test_one_rank_placements_and_dp_constraint(inputs, one_rank):
    x = torch.as_tensor(inputs["host"])
    assert parallel.dp_constraint(x, None) is x
    assert torch.equal(parallel.dp_constraint(x, one_rank), x)
    for placed in (parallel.shard_leading_axis(one_rank, x),
                   parallel.replicate(one_rank, x)):
        assert torch.equal(placed.to_local(), x)
    assert not distributed.is_multiprocess()


def test_one_rank_sampling_is_bit_equal(inputs, one_rank):
    first = torch.as_tensor(inputs["first"])
    diff = _sampler()
    for kw in ({"only_last": True}, {"step": 2}):
        got = diff.sample(SAMPLE["iters"], first_x=first, mesh=one_rank, **kw)
        want = diff.sample(SAMPLE["iters"], first_x=first, **kw)
        assert torch.equal(got, want)
    assert torch.equal(diff.sample_stack_fn(first, 3, mesh=one_rank),
                       diff.sample_stack_fn(first, 3))


def test_one_rank_sweep_is_bit_equal(inputs, one_rank):
    trials = make_mesh(1, ("trial",), device="cpu")
    got = _sweep(inputs["sweep_x"], trials)
    want = _sweep(inputs["sweep_x"])
    np.testing.assert_array_equal(got.loss_curves, want.loss_curves)
    np.testing.assert_array_equal(got.ssim, want.ssim)
    assert "trial" in got.param_sharding and want.param_sharding is None


def test_one_rank_dcp_restore_onto_trial_placement(tmp_path, one_rank):
    stacked = stacked_variables()
    ckpt.save_dcp(tmp_path / "s.dcp", stacked, epochs=2)
    trials = make_mesh(1, ("trial",), device="cpu")
    got = ckpt.load_dcp(tmp_path / "s.dcp", like=stacked,
                        sharding=NamedSharding(trials, "trial"))
    assert got["meta"]["epochs"] == 2
    leaf = got["variables"]["params"]["qweights"]
    assert "Shard(dim=0)" in str(leaf.placements)
    np.testing.assert_array_equal(leaf.to_local().numpy(),
                                  stacked["params"]["qweights"])


def test_a_new_group_gets_a_new_sharded_program(monkeypatch):
    """Meshes of one layout compare equal; a group formed after a shutdown
    must not reuse the program bound to the destroyed group."""
    from qiddm_tpu_torch.sim import engine, sharded

    for key in _ENV:
        monkeypatch.delenv(key, raising=False)
    gen = torch.Generator().manual_seed(0)
    x, w = torch.rand((3, 4), generator=gen), torch.rand((2, 2, 4, 3),
                                                         generator=gen)
    before = sharded._cached_reupload_program.cache_info().misses
    outs = []
    for _ in range(2):
        mesh = make_mesh(1, device="cpu")
        try:
            outs.append(engine.reupload_block(x, w, mesh=mesh))
        finally:
            distributed.shutdown()
    assert sharded._cached_reupload_program.cache_info().misses == before + 2
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0], engine.reupload_block(x, w),
                               rtol=0, atol=1e-6)


# --- four ranks ----------------------------------------------------------------

def test_data_parallel_training_matches_one_process(ranks, inputs):
    """10 rows a step over 4 ranks (3, 3, 3, 1), the last batch padded."""
    want, net = _train(inputs, None)
    for r in ranks[1]:
        np.testing.assert_allclose(r["dp_losses"], want, rtol=5e-4)
        np.testing.assert_allclose(r["dp_checksum"], _checksum(net),
                                   rtol=1e-3)


@pytest.mark.parametrize("case", sorted(CHAIN))
def test_data_parallel_step_matches_jax_chain_loss(ranks, inputs, case):
    """One Diffusion._dp_update on 4 ranks, on the JAX package's draws with
    a padded image: every rank's all-reduced loss and gradients are the
    JAX chain loss and its jax.grad on the whole batch (the rows' split,
    the whole batch's denominator, the gradient flags; with T 1 a rank
    has no rows and only draws)."""
    T = CHAIN[case]
    results = [r["chain"][case] for r in ranks[1]]
    loss, grads, variables = results[0]
    jnet = jnn.QIDDM_LL_noise(*LL_MODEL, seed=0)
    jdiff = JDiffusion(jnet, shape=(8, 8))

    def jloss(params):
        return jdiff._chain_loss(
            params, jnet.extra_variables, _chain_key(case),
            jnp.asarray(inputs["chain_x"]), T,
            valid=jnp.asarray(CHAIN_VALID, jnp.float32))[0]

    want, jgrads = jax.value_and_grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    assert abs(loss - float(want)) <= 1e-5 * abs(float(want))
    assert {p[1] for p in grads} == {"linear_down", "qweights", "linear_up"}
    for path, g in grads.items():
        ref = jgrads
        for k in path[1:]:
            ref = ref[k]
        ref = np.asarray(ref)
        assert np.abs(g - ref).max() <= 1e-4 * np.abs(ref).max(), path
    for other in results[1:]:  # one all-reduce: the same bits everywhere
        assert other[0] == loss
        for path, g in other[1].items():
            np.testing.assert_array_equal(g, grads[path])


def test_data_parallel_sampling_matches_one_process(ranks, inputs):
    diff = _sampler()
    first = torch.as_tensor(inputs["first"])
    last = diff.sample(SAMPLE["iters"], first_x=first, only_last=True)
    stack = diff.sample_stack_fn(first, SAMPLE["iters"])
    for r in ranks[1]:
        np.testing.assert_allclose(r["sample_last"], last.numpy(), atol=1e-5)
        np.testing.assert_allclose(r["sample_stack"], stack.numpy(),
                                   atol=1e-5)


def test_sample_cli_mesh_devices_matches_one_process(ranks, tmp_path):
    out, results = ranks
    want = sample_cli.main(cli_argv(out / "cli_net.pt", tmp_path / "one"))
    for r in results:
        np.testing.assert_allclose(r["cli"], want, atol=1e-5)
    # rank 0 writes the images, the others nothing
    got = np.load(out / "cli_rank0" / "samples.npz")["images"]
    np.testing.assert_allclose(got, want, atol=1e-5)
    for rank in (1, 2, 3):
        assert not (out / f"cli_rank{rank}").exists()


def test_trial_sweep_pads_ragged_trials(ranks, inputs, tmp_path):
    """3 trials on 4 ranks: the sweep's results are the mesh-free sweep's,
    rank 0 writes one result.json per trial."""
    out, results = ranks
    want = _sweep(inputs["sweep_x"], local_dir=str(tmp_path))
    for r in results:
        curves, ssim, sharding, _ = r["sweep"]
        np.testing.assert_allclose(curves, want.loss_curves, rtol=2e-4)
        np.testing.assert_allclose(ssim, want.ssim, rtol=2e-3, atol=1e-5)
        assert "trial" in sharding
    assert [len(r["sweep"][3]) for r in results] == [3, 0, 0, 0]
    tdirs = sorted((out / "sweep" / "pad").iterdir())
    assert len(tdirs) == 3
    for td in tdirs:
        rec = json.loads((td / "result.json").read_text())
        assert {"loss", "ssim", "training_iteration"} <= set(rec)
        assert any(p.suffix == ".pt" for p in td.iterdir())


def test_host_local_batch_replicate_and_to_host(ranks, inputs):
    for r in ranks[1]:
        shape, full = r["host_local"]
        assert shape == inputs["host"].shape
        np.testing.assert_array_equal(full, inputs["host"])
        assert r["replicated"] == 2.5


def test_shard_replicate_and_dp_constraint(ranks, inputs):
    """Each rank keeps its two of the 8 rows; a replicated array is whole
    on every rank; the global mesh spans the 4 ranks."""
    host = inputs["host"]
    for r in ranks[1]:
        p = r["placed"]
        mine = host[2 * r["rank"]:2 * r["rank"] + 2]
        placement, local, full = p["sharded"]
        assert "Shard(dim=0)" in placement
        np.testing.assert_array_equal(local, mine)
        np.testing.assert_array_equal(full, host)
        assert "Replicate()" in p["replicated"][0]
        np.testing.assert_array_equal(p["replicated"][1], host)
        np.testing.assert_array_equal(p["dp_rows"], mine)
        assert p["global"] == (("data",), 4, True)


def test_dcp_restore_onto_trial_placement(ranks):
    """Each rank reads only its own trial's rows, no unsharded copy."""
    stacked = leaves(stacked_variables())
    for r in ranks[1]:
        restored, meta = r["dcp"]
        assert meta == {"loss_values": [0.25], "epochs": 3}
        assert len(restored) == len(stacked)
        for want, (placement, shape, local) in zip(stacked, restored):
            assert "Shard(dim=0)" in placement and shape == want.shape
            assert local.shape == (1,) + want.shape[1:]
            np.testing.assert_array_equal(local, want[r["rank"]:r["rank"] + 1])
        assert r["dcp_one"] == 0.0  # a replicated restore into a net


def test_mesh_check_tool_on_four_ranks(ranks):
    """tools/mesh_check.py's checks pass on 4 CPU ranks; every rank holds
    the same report."""
    reports = [r["mesh_check"] for r in ranks[1]]
    assert reports[0]["ok"] and reports[0]["ranks"] == 4
    assert reports[0]["route_rates"]["collectives_a_step"]["p2p"] > 0
    run = reports[0]["training"]["run"]
    assert run["split"] == 4 and set(run["losses"]) == {
        "one_device", "mesh", "row_split"}
    for rep in reports[1:]:
        assert rep["ok"] and rep["route"]["expvalz"] == reports[0][
            "route"]["expvalz"]


def test_batch_coupled_model_refused_on_a_data_mesh(ranks):
    assert "PCA refit" in ranks[1][0]["refit_refused"]


# --- set-up and refusals -------------------------------------------------------

def test_initialize_rejects_topology_without_coordinator(monkeypatch):
    for key in _ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(num_processes=8, process_id=3, device="cpu")
    assert distributed.initialize(device="cpu") is False
    assert not dist.is_initialized()


def test_make_mesh_refuses_more_devices_than_ranks(monkeypatch):
    for key in _ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="requested a 2-device mesh but "
                                         "only 1 device"):
        make_mesh(2, device="cpu")
    assert not dist.is_initialized()
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            make_mesh(1)
        assert not dist.is_initialized()
