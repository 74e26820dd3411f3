"""The ported sampling slice as a whole against qiddm_tpu.diffusion, and
the port's sampling CLI on the CPU.

Same weights (carried across with load_jax_variables) and the same start
images go through both packages. Tolerance: <= 1e-4 on the sampled images
— 3 iterations of QIDDM_LL_noise(784, 6, 14, 2) in float32, through
independent formulations of the circuit (see test_torch_model.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import ckpt as jckpt
from qiddm_tpu import nn as jnn
from qiddm_tpu.diffusion import Diffusion as JDiffusion
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch.cli import sample as tsample
from qiddm_tpu_torch.diffusion import Diffusion as TDiffusion
from qiddm_tpu_torch.nn import QIDDM_LL_noise

TOL = 1e-4
MODEL = (784, 6, 14, 2)


@pytest.fixture(scope="module")
def nets():
    jnet = jnn.QIDDM_LL_noise(*MODEL, seed=11)
    tnet = QIDDM_LL_noise(*MODEL, device="cpu")
    tckpt.load_jax_variables(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.variables))
    return jnet, tnet


@pytest.mark.parametrize("goal", ["data", "noise"])
@pytest.mark.parametrize("only_last", [True, False])
def test_sampling_matches_jax(nets, goal, only_last):
    jnet, tnet = nets
    first_x = (np.random.default_rng(1).uniform(size=(4, 1, 28, 28))
               * 0.75 + 0.5).astype(np.float32)
    want = np.asarray(JDiffusion(jnet, prediction_goal=goal).eval().sample(
        n_iters=3, first_x=jnp.asarray(first_x), only_last=only_last,
        noise_factor=2.0))
    got = TDiffusion(tnet, prediction_goal=goal).eval().sample(
        n_iters=3, first_x=torch.as_tensor(first_x), only_last=only_last,
        noise_factor=2.0).numpy()
    assert got.shape == want.shape
    assert got.shape == ((4, 1, 28, 28) if only_last else (4 * 28, 4 * 28))
    np.testing.assert_allclose(got, want, atol=TOL)


def test_sample_stack_matches_grid(nets):
    _, tnet = nets
    first_x = torch.rand((2, 1, 28, 28),
                         generator=torch.Generator().manual_seed(0))
    diff = TDiffusion(tnet).eval()
    stack = diff.sample_stack_fn(first_x, 2)
    grid = diff.sample_fn(first_x, 2)
    assert stack.shape == (3, 2, 1, 28, 28)
    # grid rows are iterations x height, columns batch x width
    assert torch.equal(grid[28:56, 28:56], stack[1, 1, 0])
    assert diff.save_name() == "QIDDM_LL_noise=6_L=14_N=2"
    assert TDiffusion(tnet, prediction_goal="noise").save_name() == \
        "QIDDM_LL_noise=6_L=14_N=2_noise"


def _jax_ckpt(tmp_path, nets):
    jnet, _ = nets
    return jckpt.save_checkpoint(tmp_path / f"{jnet.save_name()}_4.pt",
                                 jnet.variables, [], 0)


def test_cli_samples_jax_checkpoint_on_cpu(tmp_path, nets):
    ck = _jax_ckpt(tmp_path, nets)
    out = tmp_path / "out"
    imgs = tsample.main(["--ckpt", str(ck), "--model", "QIDDM_LL_noise",
                         "784", "6", "14", "2", "--n", "3", "--iters", "2",
                         "--batches", "2", "--device", "cpu", "--out",
                         str(out)])
    saved = np.load(out / "samples.npz")["images"]
    assert saved.shape == (6, 1, 28, 28)
    assert np.isfinite(saved).all()
    np.testing.assert_array_equal(saved, imgs)


def test_cli_format_defaults_to_both_as_the_jax_cli(tmp_path, nets):
    from qiddm_tpu.cli import sample as jsample

    argv = ["--model", "QIDDM_LL_noise", "784", "6", "14", "2", "--ckpt",
            "x.pt"]
    assert tsample.parse_args(argv).format == "both"
    assert jsample.parse_args(argv).format == "both"
    ck = _jax_ckpt(tmp_path, nets)
    out = tmp_path / "out"
    imgs = tsample.main(["--ckpt", str(ck), "--model", "QIDDM_LL_noise",
                         "784", "6", "14", "2", "--n", "2", "--iters", "1",
                         "--device", "cpu", "--out", str(out)])
    np.testing.assert_array_equal(np.load(out / "samples.npz")["images"],
                                  imgs)
    pytest.importorskip("matplotlib")
    assert sorted(p.name for p in out.glob("*.png")) == [
        "sample_0000.png", "sample_0001.png"]


def test_cli_cuda_without_a_card_raises(tmp_path, nets):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the no-fallback check needs a "
                    "host without it")
    ck = _jax_ckpt(tmp_path, nets)
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        tsample.main(["--ckpt", str(ck), "--model", "QIDDM_LL_noise", "784",
                      "6", "14", "2", "--device", "cuda", "--out",
                      str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


# the AOT flags serve now (tests/test_torch_export.py), and so does the
# mesh (tests/test_torch_parallel.py): --mesh-devices above the ranks there
# are raises before any work, naming the count
@pytest.mark.parametrize("flag", [["--mesh-devices", "2"]])
def test_cli_rejects_unported_flags(flag, monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="requested a 2-device mesh but "
                                         "only 1 device"):
        tsample.main(["--model", "QIDDM_LL_noise", "784", "6", "14", "2",
                      "--ckpt", "x.pt", "--device", "cpu", *flag])
    assert not torch.distributed.is_initialized()
