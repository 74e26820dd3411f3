"""The trajectory noise backend of qiddm_tpu_torch through the models, the
sampler and the noise drivers, against qiddm_tpu's on the CPU.

* ``with_noise(..., noise_trajectories=600)`` sampled through ``Diffusion``
  is consistent with the exact density-matrix sampler (mean |diff| < 0.08
  after 3 iterations, as tests/test_trajectories.py bounds the JAX
  package's), and the same generator seed gives the same samples.
* At intensity 0 every trajectory branch is the identity: the port's
  trajectory sampler equals the JAX package's density-matrix sampler on the
  same weights within 1e-5 (float32 through two different simulations).
* ``mnist_noise --noise-backend traj`` writes ``*_outp_*_traj.pt`` caches
  that the JAX package's ``load_outp(..., backend="traj")`` reads, and at
  intensity 0 its SSIM equals the dm run's within 1e-4.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import nn as jnn
from qiddm_tpu.cli import common as jcommon
from qiddm_tpu.diffusion import Diffusion as JDiffusion
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch import nn as tnn
from qiddm_tpu_torch.cli import common as tcommon
from qiddm_tpu_torch.diffusion import Diffusion as TDiffusion
from qiddm_tpu_torch.sim import amp_damp_kernel

ZERO_TOL = 1e-5


def _first_x(seed, n=2, side=8):
    return torch.as_tensor(np.random.default_rng(seed).uniform(
        size=(n, 1, side, side)), dtype=torch.float32)


def test_trajectory_sampling_is_consistent_with_the_dm_sampler():
    net = tnn.QIDDM_LL_noise(64, 4, 2, 1, 0, seed=1, device="cpu")
    first_x = _first_x(0)
    dm = TDiffusion(tcommon.with_noise(net, 2, 0.05), shape=(8, 8))
    want = dm.sample(first_x=first_x, n_iters=3, only_last=True)
    noisy = tcommon.with_noise(net, 2, 0.05, noise_trajectories=600)
    assert noisy.module.noise_trajectories == 600
    assert net.module.noise_trajectories == 0  # the trained net keeps dm
    tr = TDiffusion(noisy, shape=(8, 8))
    got = tr.sample(first_x=first_x, n_iters=3, only_last=True,
                    traj_rng=torch.Generator().manual_seed(8))
    assert got.shape == want.shape
    # iterated denoising compounds the Monte-Carlo error through the linear
    # head: the bound pins consistency, not exactness
    assert (got - want).abs().mean().item() < 0.08
    again = tr.sample(first_x=first_x, n_iters=3, only_last=True,
                      traj_rng=torch.Generator().manual_seed(8))
    assert torch.equal(got, again)
    other = tr.sample(first_x=first_x, n_iters=3, only_last=True,
                      traj_rng=torch.Generator().manual_seed(9))
    assert not torch.equal(got, other)
    # a noisy net on the trajectory backend without a source raises
    with pytest.raises(ValueError, match="random source"):
        tr.sample(first_x=first_x, n_iters=1)


@pytest.mark.parametrize("name,args,code", [
    ("QIDDM_LL_noise", (64, 3, 2, 2), 1),
    ("QIDDM_LL_noise", (64, 3, 2, 2), 2),
    ("QIDDM_PL_noise1", (64, 4, 2, 2), 3),
    ("QNN_noise", (64, 3, 2), 2),
    ("QDenseUndirected_old_noise", (8, 2), 2),
])
def test_traj_sampler_at_intensity_zero_equals_jax_dm_sampler(name, args,
                                                              code):
    jnet = getattr(jnn, name)(*args, seed=2)
    tnet = getattr(tnn, name)(*args, device="cpu")
    tckpt.load_jax_variables(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.variables))
    side = tnet.img_shape[0]
    first_x = (_first_x(3, n=10, side=side) * 0.75 + 0.5).numpy()
    jdiff = JDiffusion(jcommon.with_noise(jnet, code, 0.0),
                       shape=(side, side))
    want = np.asarray(jdiff.sample_fn(jdiff.net.variables,
                                      jnp.asarray(first_x), 3,
                                      only_last=False))
    before = amp_damp_kernel.AMP_DAMP_LAUNCHES
    tdiff = TDiffusion(tcommon.with_noise(tnet, code, 0.0,
                                          noise_trajectories=4),
                       shape=(side, side))
    got = tdiff.sample_fn(torch.as_tensor(first_x), 3, only_last=False,
                          traj_rng=torch.Generator().manual_seed(0))
    assert amp_damp_kernel.AMP_DAMP_LAUNCHES == before  # the CPU's twin
    np.testing.assert_allclose(got.numpy(), want, atol=ZERO_TOL)


@pytest.fixture
def driver_env(tmp_path, monkeypatch):
    """A scratch working directory, with stdout and stderr restored after
    the drivers tee them into their log."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    monkeypatch.setenv("HOME", str(tmp_path))
    return tmp_path


def test_mnist_noise_traj_backend_writes_traj_caches(driver_env):
    from qiddm_tpu_torch.cli import mnist_noise
    from qiddm_tpu_torch.cli.noise_common import run_noise_sweep

    tmp = driver_env
    argv = ["--data", "mnist_8x8", "--img_size", "8",
            "--model", "QIDDM_LL_noise", "64", "4", "2", "1",
            "--ds-size", "120", "--epochs", "1", "--batch_size", "8",
            "--tau", "2", "--label", "3", "--device", "cpu",
            "--save-path", f"{tmp}/t_", "--load-path", f"{tmp}/t_"]
    res_dm = run_noise_sweep(mnist_noise.parse_args(argv), noise_types=[2],
                             intensities=[0.0, 0.05], tau_test=2)
    res_tr = run_noise_sweep(
        mnist_noise.parse_args(argv + ["--noise-backend", "traj",
                                       "--n-traj", "64"]),
        noise_types=[2], intensities=[0.0, 0.05], tau_test=2)
    cache_dir = tmp / "t_3" / "noise_2"
    names = sorted(p.name for p in cache_dir.glob("*.pt"))
    assert names == sorted(f"QIDDM_LL_noise=4_L=2_N=1_outp_{v}{tag}.pt"
                           for v in (0.0, 0.05) for tag in ("", "_traj"))
    # intensity 0: every trajectory branch is the identity
    np.testing.assert_allclose(res_tr["QIDDM_LL_noise"][2]["ssim"][0],
                               res_dm["QIDDM_LL_noise"][2]["ssim"][0],
                               atol=1e-4)
    assert np.isfinite(res_tr["QIDDM_LL_noise"][2]["ssim"]).all()
    # each package reads the other's trajectory cache
    jdiff = JDiffusion(jnn.QIDDM_LL_noise(64, 4, 2, 1), shape=(8, 8))
    grid = jcommon.load_outp(jdiff, cache_dir, 0.05, backend="traj")
    assert grid.shape == (3 * 8, 10 * 8) and grid.dtype == np.float32
    tdiff = TDiffusion(tnn.QIDDM_LL_noise(64, 4, 2, 1, device="cpu"),
                       shape=(8, 8))
    assert np.array_equal(
        tcommon.load_outp(tdiff, cache_dir, 0.05, backend="traj"), grid)
    dm_grid = tcommon.load_outp(tdiff, cache_dir, 0.05)
    assert not np.array_equal(dm_grid, grid)
