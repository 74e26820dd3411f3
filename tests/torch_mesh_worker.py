"""Worker for tests/test_torch_sharded.py and tests/test_torch_parallel.py:
runs the port's mesh code on CPU ranks (gloo collectives) and writes each
rank's results to a pickle. It imports no JAX: the tests hold the results
against the JAX package in the pytest process.

Usage: python tests/torch_mesh_worker.py <suite> <ranks> <port> <out_dir>
with suite "sharded" or "parallel". The inputs are made from seeded numpy
by the functions below, which the tests call too.
"""

import os
import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]

SEL_GRID = [(5, 3, "cnot"), (5, 3, "cz"), (6, 4, "cnot"), (4, 2, "cz")]
ENCODES = ("rz", "rz_halfpi", "ry")
RINGS = ("cz", "cnot")
READOUTS = ("expvalz", "probs")
GRAD_CASES = [(e, r) for e in ("rz", "ry") for r in RINGS]
GROUPED_CASES = [("rz", "cz"), ("ry", "cnot")]
CHANNELS = ("amplitude_damping", "depolarizing", "phase_damping")
PL_MODEL = (64, 5, 2, 1, 0)
LL_MODEL = (64, 4, 2, 1, 0)
# data-parallel training: 9 images at batch 2 (the last batch padded), tau
# 5: 10 rows a step, split 3, 3, 3, 1 over 4 ranks
DP = {"n": 9, "batch_size": 2, "T": 5, "epochs": 2, "lr": 0.01, "key": 5}
SAMPLE = {"n": 10, "iters": 5}
SWEEP = {"lrs": [0.005, 0.01, 0.02], "epochs": 2, "batch_size": 4, "T": 3,
         "sample_iters": 3, "seed": 3}
# qiddm_tpu_torch/tools/mesh_check.py at a small size on the CPU ranks
MESH_CHECK_ARGV = ["--device", "cpu", "--wires", "6", "--L", "2", "--model",
                   "QIDDM_LL_noise", "64", "4", "2", "1", "--images", "3"]
# one data-parallel step (Diffusion._dp_update) on draws the tests make
# with the JAX package (CHAIN_DRAWS in the output directory): 5 images, the
# last a pad at weight 0; T 2 gives 10 rows (3, 3, 3, 1 over 4 ranks), T 1
# gives 5 (2, 2, 1 and an empty rank)
CHAIN = {"ten_rows": 2, "empty_rank": 1}
CHAIN_VALID = [1.0, 1.0, 1.0, 1.0, 0.0]
CHAIN_DRAWS = "chain_draws.npz"


def _f32(a):
    return np.asarray(a, np.float32)


def sharded_inputs():
    rng = np.random.default_rng(51)
    d = {}
    for wires, layers, ring in SEL_GRID:
        d[f"sel/{wires}/{layers}/{ring}"] = _f32(
            rng.normal(size=(layers, wires, 3)) * 0.4)
    d["norm_w"] = _f32(rng.normal(size=(5, 6, 3)) * 0.4)
    d["flow_w"] = _f32(rng.normal(size=(2, 5, 3)) * 0.4)
    d["re_w"] = _f32(rng.normal(size=(2, 2, 5, 3)) * 0.5)
    d["re_x"] = _f32(rng.uniform(size=(6, 5)) * 2.0)
    d["rot_w"] = _f32(rng.normal(size=(2, 2, 5, 3)) * 0.5)
    d["rot_x"] = _f32(rng.uniform(size=(3, 5)))
    d["adj_w"] = _f32(rng.normal(size=(2, 2, 5, 3)) * 0.5)
    d["adj_x"] = _f32(rng.uniform(size=(3, 5)) * 2.0)
    d["adj_c"] = _f32(rng.normal(size=(3, 5)))
    d["full_w"] = _f32(rng.normal(size=(2, 2, 2, 3)) * 0.5)
    d["full_x"] = _f32(rng.uniform(size=(3, 2)) * 2.0)
    d["full_c"] = _f32(rng.normal(size=(3, 2)))
    d["grp_w"] = _f32(rng.normal(size=(2, 2, 9, 3)) * 0.5)
    d["grp_x"] = _f32(rng.uniform(size=(2, 9)) * 2.0)
    d["grp_c"] = _f32(rng.normal(size=(2, 9)))
    d["x64_w"] = rng.normal(size=(2, 2, 5, 3)) * 0.5
    d["x64_x"] = rng.uniform(size=(3, 5))
    d["traj_w"] = _f32(rng.normal(size=(2, 2, 5, 3)) * 0.5)
    d["traj_x"] = _f32(rng.uniform(size=(3, 5)) * 2.0)
    # 8 distinct images: a centred rank above the PCA's 5 components
    d["pl_x"] = _f32(rng.uniform(size=(8, 1, 8, 8)))
    return d


def parallel_inputs():
    rng = np.random.default_rng(27)
    d = {"x": _f32(rng.uniform(size=(DP["n"], 64))),
         "first": _f32(rng.uniform(size=(SAMPLE["n"], 1, 8, 8))),
         "sweep_x": _f32(rng.uniform(size=(12, 64))),
         "host": _f32(rng.uniform(size=(8, 64))),
         "chain_x": _f32(rng.uniform(size=(len(CHAIN_VALID), 64)))}
    d["chain_x"][-1] = d["chain_x"][0]  # the dropless pad: a copy of row 0
    return d


# --- the suites (port only) --------------------------------------------------

def _t(a, grad=False):
    import torch

    return torch.tensor(np.asarray(a), requires_grad=grad)


def _grads(fn, *args):
    import torch

    ts = [_t(a, True) for a in args]
    out = fn(*ts)
    return [g.numpy() for g in torch.autograd.grad(out, ts)]


def run_sharded(mesh, out: pathlib.Path) -> dict:
    import functools

    import torch

    from qiddm_tpu_torch import config
    from qiddm_tpu_torch.ckpt import load_jax_variables
    from qiddm_tpu_torch.nn import QIDDM_PL_noise1
    from qiddm_tpu_torch.sim import engine
    from qiddm_tpu_torch.sim.sharded import (
        ShardedState,
        expval_z_sharded,
        make_sel_program,
        probs_sharded,
        reupload_block_sharded,
        zero_state_sharded,
    )

    d = sharded_inputs()
    r = {}
    for wires, layers, ring in SEL_GRID:
        spec = ShardedState(wires, mesh)
        state = make_sel_program(spec, layers, ring)(
            zero_state_sharded(spec), _t(d[f"sel/{wires}/{layers}/{ring}"]))
        r[f"sel/{wires}/{layers}/{ring}"] = (
            state.full_tensor().reshape(-1).detach().numpy(),
            probs_sharded(spec, state).full_tensor().reshape(-1)
            .detach().numpy(),
            expval_z_sharded(spec, state).detach().numpy(), spec.shard_bits)
    spec = ShardedState(6, mesh)
    state = make_sel_program(spec, 5, "cnot")(zero_state_sharded(spec),
                                               _t(d["norm_w"]))
    r["norm"] = float(probs_sharded(spec, state).full_tensor().sum())
    spec = ShardedState(5, mesh)
    prog = make_sel_program(spec, 2, "cz")
    r["flow"] = _grads(lambda w: (expval_z_sharded(
        spec, prog(zero_state_sharded(spec), w)) ** 2).sum(), d["flow_w"])[0]

    x, w = _t(d["re_x"]), _t(d["re_w"])
    with torch.no_grad():
        for enc in ENCODES:
            for ring in RINGS:
                for ro in READOUTS:
                    r[f"re/{enc}/{ring}/{ro}"] = reupload_block_sharded(
                        x, w, mesh, imprimitive=ring, encode=enc,
                        readout=ro).numpy()
        for enc in ("rz", "ry"):
            r[f"route/{enc}"] = engine.reupload_block(
                x[:4], w, encode=enc, readout="expvalz", mesh=mesh).numpy()
        rot = engine.NoiseModel("rot_angle", 0.1, "encode")
        for enc in ("rz", "rz_halfpi"):
            r[f"rot/{enc}"] = engine.reupload_block(
                _t(d["rot_x"]), _t(d["rot_w"]), encode=enc,
                readout="expvalz", noise=rot, mesh=mesh).numpy()
        for ro in READOUTS:
            for mode in ("off", "auto"):
                config.set_adjoint_mode(mode)
                try:
                    r[f"adjval/{ro}/{mode}"] = reupload_block_sharded(
                        _t(d["rot_x"]), _t(d["rot_w"]), mesh,
                        readout=ro).numpy()
                finally:
                    config.set_adjoint_mode("auto")

    coeff = _t(d["adj_c"])
    for enc, ring in GRAD_CASES:
        for mode in ("off", "auto"):
            config.set_adjoint_mode(mode)
            try:
                r[f"adj/{enc}/{ring}/{mode}"] = _grads(
                    lambda ww, xx: (coeff * reupload_block_sharded(
                        xx, ww, mesh, encode=enc, imprimitive=ring,
                        readout="expvalz")).sum(), d["adj_w"], d["adj_x"])
            finally:
                config.set_adjoint_mode("auto")
    r["halfpi_grad"] = _grads(lambda xx: (coeff * reupload_block_sharded(
        xx, _t(d["rot_w"]), mesh, encode="rz_halfpi")).sum(), d["rot_x"])[0]
    fc = _t(d["full_c"])
    with torch.no_grad():
        r["full_val"] = reupload_block_sharded(
            _t(d["full_x"]), _t(d["full_w"]), mesh).numpy()
    r["full_grad"] = _grads(lambda ww: (fc * reupload_block_sharded(
        _t(d["full_x"]), ww, mesh)).sum(), d["full_w"])[0]
    r["full_bits"] = ShardedState(2, mesh).shard_bits

    gc = _t(d["grp_c"])
    for enc, ring in GROUPED_CASES:
        for wide in ("auto", "off"):
            for adj in ("auto", "off"):
                config.set_wide_mode(wide)
                config.set_adjoint_mode(adj)
                try:
                    ts = [_t(d["grp_w"], True), _t(d["grp_x"], True)]
                    val = (gc * reupload_block_sharded(
                        ts[1], ts[0], mesh, encode=enc, imprimitive=ring,
                        readout="expvalz")).sum()
                    grads = torch.autograd.grad(val, ts)
                    r[f"grp/{enc}/{ring}/{wide}/{adj}"] = (
                        float(val), [g.numpy() for g in grads])
                finally:
                    config.set_wide_mode("auto")
                    config.set_adjoint_mode("auto")

    with torch.no_grad():
        x64, w64 = _t(d["x64_x"]), _t(d["x64_w"])
        r["x64"] = [engine.reupload_block(
            x64, w64, readout="expvalz", cdtype=torch.complex128,
            mesh=m).numpy() for m in (mesh, None)]
        for kind in CHANNELS:
            noise = engine.NoiseModel(kind, 0.3, "encode")
            for ro in READOUTS:
                r[f"traj/{kind}/{ro}"] = [engine.reupload_block(
                    _t(d["traj_x"]), _t(d["traj_w"]), noise=noise,
                    readout=ro, mesh=m, n_traj=4,
                    traj_rng=torch.Generator().manual_seed(3)).numpy()
                    for m in (mesh, None)]
        net = QIDDM_PL_noise1(*PL_MODEL, seed=0, device="cpu")
        with open(out / "pl_variables.pkl", "rb") as f:
            load_jax_variables(net, pickle.load(f))
        orig = engine.reupload_block
        engine.reupload_block = functools.partial(orig, mesh=mesh)
        try:
            r["pl"] = net(_t(d["pl_x"])).numpy()
        finally:
            engine.reupload_block = orig
        r["pl_dense"] = net(_t(d["pl_x"])).numpy()
    return r


def _param_checksum(net) -> float:
    return float(sum(p.detach().abs().sum() for p in net.parameters()))


def run_parallel(mesh, out: pathlib.Path) -> dict:
    import torch
    import torch.distributed as dist

    from qiddm_tpu_torch import ckpt
    from qiddm_tpu_torch.cli import sample as sample_cli
    from qiddm_tpu_torch.diffusion import Diffusion
    from qiddm_tpu_torch.nn import QIDDM_LL_noise
    from qiddm_tpu_torch.parallel import (
        NamedSharding,
        dp_constraint,
        make_mesh,
        replicate,
        shard_leading_axis,
    )
    from qiddm_tpu_torch.parallel.distributed import (
        global_mesh,
        host_local_batch,
        is_multiprocess,
        replicate_from_host,
        to_host,
    )
    from qiddm_tpu_torch.sweep import sweep_lr
    from qiddm_tpu_torch.train import train_diffusion_scan

    d = parallel_inputs()
    rank = dist.get_rank()
    r = {"rank": rank}
    net = QIDDM_LL_noise(*LL_MODEL, seed=0, device="cpu")
    diff = Diffusion(net, shape=(8, 8))
    losses, _ = train_diffusion_scan(
        diff, d["x"], epochs=DP["epochs"], batch_size=DP["batch_size"],
        lr=DP["lr"], T=DP["T"], key=DP["key"], mesh=mesh, warmup=False)
    r["dp_losses"], r["dp_checksum"] = losses, _param_checksum(net)

    r["chain"] = _chain_steps(mesh, d, out)

    net = QIDDM_LL_noise(*LL_MODEL, seed=0, device="cpu")
    diff = Diffusion(net, shape=(8, 8)).eval()
    first = torch.as_tensor(d["first"])
    r["sample_last"] = diff.sample(SAMPLE["iters"], first_x=first,
                                   only_last=True, mesh=mesh).numpy()
    r["sample_stack"] = diff.sample_stack_fn(first, SAMPLE["iters"],
                                             mesh=mesh).numpy()

    ck = out / "cli_net.pt"
    if rank == 0:
        ckpt.save_checkpoint(ck, ckpt.export_jax_variables(net), [0.5], 1)
    dist.barrier()
    r["cli"] = sample_cli.main(cli_argv(ck, out / f"cli_rank{rank}") + [
        "--mesh-devices", str(dist.get_world_size())])

    local = d["host"][2 * rank:2 * rank + 2]
    glob = host_local_batch(local, mesh)
    r["host_local"] = (tuple(glob.shape), to_host(glob))
    r["replicated"] = float(to_host(replicate_from_host(
        {"b": np.float32(2.5)}, mesh)["b"]))
    sharded = shard_leading_axis(mesh, {"h": d["host"]})["h"]
    copied = replicate(mesh, [d["host"]])[0]
    whole = global_mesh(device="cpu")
    r["placed"] = {
        "sharded": (str(sharded.placements), sharded.to_local().numpy(),
                    to_host(sharded)),
        "replicated": (str(copied.placements), copied.to_local().numpy()),
        "dp_rows": dp_constraint(torch.as_tensor(d["host"]), mesh).numpy(),
        "global": (whole.mesh_dim_names, whole.size(), is_multiprocess())}

    trials = make_mesh(dist.get_world_size(), ("trial",), device="cpu")
    res = sweep_lr(lambda s: QIDDM_LL_noise(*LL_MODEL, seed=s, device="cpu"),
                   SWEEP["lrs"], d["sweep_x"], shape=(8, 8),
                   epochs=SWEEP["epochs"], batch_size=SWEEP["batch_size"],
                   T=SWEEP["T"], sample_iters=SWEEP["sample_iters"],
                   seed=SWEEP["seed"], mesh=trials,
                   local_dir=str(out / "sweep"), exp_name="pad")
    r["sweep"] = (res.loss_curves, res.ssim, res.param_sharding,
                  res.trial_dirs)

    stacked = stacked_variables()
    path = out / "stacked.dcp"
    if rank == 0:
        ckpt.save_dcp(path, stacked, loss_values=[0.25], epochs=3)
    dist.barrier()
    got = ckpt.load_dcp(path, like=stacked,
                        sharding=NamedSharding(trials, "trial"))
    r["dcp"] = ([(str(t.placements), tuple(t.shape),
                  t.to_local().numpy()) for t in leaves(got["variables"])],
                got["meta"])
    net2 = QIDDM_LL_noise(*LL_MODEL, seed=9, device="cpu")
    ckpt.load_dcp_into(net2, _save_one(net, out, rank),
                       sharding=NamedSharding(mesh))
    r["dcp_one"] = _param_checksum(net2) - _param_checksum(net)

    from qiddm_tpu_torch.nn import QIDDM_PL_noise1

    from qiddm_tpu_torch.tools import mesh_check

    r["mesh_check"] = mesh_check.main(MESH_CHECK_ARGV)

    pca = Diffusion(QIDDM_PL_noise1(*PL_MODEL, seed=0, device="cpu"),
                    shape=(8, 8))
    try:
        train_diffusion_scan(pca, d["x"], epochs=1, batch_size=4, lr=0.01,
                             T=2, mesh=mesh, warmup=False)
        r["refit_refused"] = ""
    except NotImplementedError as err:
        r["refit_refused"] = str(err)
    return r


def _chain_steps(mesh, d, out: pathlib.Path) -> dict:
    """{case: (the step's loss, {flax path: gradient}, the weights as JAX
    variables)} of one ``Diffusion._dp_update`` at lr 0 for each CHAIN
    case, the noise the given draw."""
    import torch

    from qiddm_tpu_torch import ckpt
    from qiddm_tpu_torch.diffusion import Diffusion
    from qiddm_tpu_torch.nn import QIDDM_LL_noise
    from qiddm_tpu_torch.noise import add_normal_noise_multiple

    draws = np.load(out / CHAIN_DRAWS)
    res = {}
    for case, T in CHAIN.items():
        net = QIDDM_LL_noise(*LL_MODEL, seed=0, device="cpu")
        variables = ckpt.export_jax_variables(net)
        draw = torch.as_tensor(draws[case])

        def noise_f(generator, data, tau, decay_mod, draw=draw):
            return add_normal_noise_multiple(generator, data, tau, decay_mod,
                                             noise=draw)

        diff = Diffusion(net, noise_f, shape=(8, 8))
        loss = diff._dp_update(torch.optim.SGD(net.parameters(), lr=0.0),
                               torch.as_tensor(d["chain_x"]), T, None,
                               torch.as_tensor(CHAIN_VALID), mesh)
        params = dict(net.module.named_parameters())
        grads = {path: (params[name].grad.numpy().T if layout
                        else params[name].grad.numpy())
                 for name, (path, layout) in ckpt._flax_paths(net).items()}
        res[case] = (float(loss), grads, variables)
    return res


def _save_one(net, out: pathlib.Path, rank: int) -> pathlib.Path:
    import torch.distributed as dist

    from qiddm_tpu_torch import ckpt

    path = out / "one.dcp"
    if rank == 0:
        ckpt.save_dcp(path, ckpt.export_jax_variables(net))
    dist.barrier()
    return path


def leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def stacked_variables():
    """Four trials' parameters stacked on a leading axis (seeds 0-3)."""
    from qiddm_tpu_torch.ckpt import export_jax_variables
    from qiddm_tpu_torch.nn import QIDDM_LL_noise

    trees = [export_jax_variables(QIDDM_LL_noise(*LL_MODEL, seed=s,
                                                 device="cpu"))["params"]
             for s in range(4)]

    def stack(ts):
        if isinstance(ts[0], dict):
            return {k: stack([t[k] for t in ts]) for k in ts[0]}
        return np.stack(ts)

    return {"params": stack(trees)}


def cli_argv(ckpt_path, out_dir) -> list:
    return ["--ckpt", str(ckpt_path), "--model", "QIDDM_LL_noise",
            *map(str, LL_MODEL[:4]), "--img_size", "8", "--n", "10",
            "--iters", "3", "--out", str(out_dir), "--format", "npz",
            "--batches", "2", "--seed", "3", "--device", "cpu"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(suite: str, out: pathlib.Path, ranks: int = 4) -> list:
    """Run ``suite`` on ``ranks`` CPU ranks in a child process (this file
    as a script); returns each rank's results."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, __file__, suite, str(ranks), str(free_port()),
         str(out)], env=env, cwd=out, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    results = []
    for r in range(ranks):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _work(rank: int, ranks: int, port: int, suite: str, out: str) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(ranks), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    from qiddm_tpu_torch.parallel import make_mesh
    from qiddm_tpu_torch.parallel.distributed import shutdown

    out = pathlib.Path(out)
    mesh = make_mesh(ranks, ("data",), device="cpu")
    try:
        fn = run_sharded if suite == "sharded" else run_parallel
        result = fn(mesh, out)
    finally:
        shutdown()
    with open(out / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    import torch.multiprocessing as mp

    suite, ranks, port, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
        sys.argv[4]
    mp.spawn(_work, args=(ranks, int(port), suite, out), nprocs=ranks)
