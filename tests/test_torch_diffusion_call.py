"""The torch-style training call of qiddm_tpu_torch's ``Diffusion``
(``attach_optimizer``, the train-mode ``__call__``) against qiddm_tpu's
``attach_optimizer(optax.adam)`` on the CPU.

Both calls draw their noise from the call count: the JAX one from
``PRNGKey(call_count)``, the port's from a CPU generator seeded with it. The
port's ``noise_f`` blends the JAX draw of that key, so both packages train on
the same noise. Tolerances are tests/test_torch_train.py's: the first
call's loss (the same weights) 1e-5 relative, the loss trace over 3 Adam
steps 1e-3 relative, per-element terms 1e-5 absolute.

The reference's driver loop is ``opt.zero_grad(); diff(x=..., T=...);
opt.step()``. JAX's optax state is functional, so the outer step does
nothing there; torch's optimizers step whatever ``.grad`` holds, so the
port's call leaves every ``.grad`` None: the outer step moves nothing and
the loop trains one step a call, bit for bit ``make_train_step``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qiddm_tpu import nn as jnn
from qiddm_tpu.diffusion import Diffusion as JDiffusion
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch import noise as tnoise
from qiddm_tpu_torch.diffusion import Diffusion as TDiffusion
from qiddm_tpu_torch.nn import QIDDM_LL_noise

LOSS_TOL = 1e-5
TRACE_TOL = 1e-3
MODEL = (64, 3, 2, 2)
LR = 0.0255
T = 3


def _jax_key_noise(generator, data, tau, decay_mod):
    """The JAX call's noise: the draw of ``PRNGKey(seed)``, the seed being
    the port generator's (the call count, or 0 for ``loss_only``)."""
    key = jax.random.PRNGKey(generator.initial_seed())
    draw = 0.5 + 0.2 * jax.random.normal(key, tuple(data.shape))
    return tnoise.add_normal_noise_multiple(
        generator, data, tau, decay_mod,
        noise=torch.as_tensor(np.array(draw)))


def _pair(seed=3):
    jnet = jnn.QIDDM_LL_noise(*MODEL, seed=seed)
    tnet = QIDDM_LL_noise(*MODEL, device="cpu")
    tckpt.load_jax_variables(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.variables))
    return (JDiffusion(jnet, shape=(8, 8)).train(),
            TDiffusion(tnet, _jax_key_noise, "data", (8, 8)).train())


def _images(n=2, seed=6):
    return np.random.default_rng(seed).uniform(size=(n, 1, 8, 8)).astype(
        np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_training_call_matches_jax_attach_optimizer():
    jdiff, tdiff = _pair()
    x = _images()
    jdiff.attach_optimizer(optax.adam(LR))
    opt = torch.optim.Adam(tdiff.parameters(), lr=LR)
    tdiff.attach_optimizer(opt)
    want, got = [], []
    for _ in range(3):
        want.append(float(jdiff(x=jnp.asarray(x), T=T)[0]))
        opt.zero_grad()
        got.append(tdiff(x=torch.as_tensor(x), T=T)[0].item())
        opt.step()
    assert _rel(got[0], want[0]) <= LOSS_TOL, (got, want)
    assert _rel(got, want) <= TRACE_TOL, (got, want)
    assert len(set(got)) == 3  # the weights moved between calls


def test_verbose_and_loss_only_match_jax():
    jdiff, tdiff = _pair(seed=4)
    x = _images(seed=7)
    j_elem, j_recon = jdiff(x=jnp.asarray(x), T=T, loss_only=True,
                            verbose=True)
    t_elem, t_recon = tdiff(x=torch.as_tensor(x), T=T, loss_only=True,
                            verbose=True)
    assert t_elem.shape == j_elem.shape and t_recon.shape == j_recon.shape
    np.testing.assert_allclose(t_elem.numpy(), np.asarray(j_elem),
                               atol=LOSS_TOL)
    np.testing.assert_allclose(t_recon.numpy(), np.asarray(j_recon),
                               atol=LOSS_TOL)
    before = [p.detach().clone() for p in tdiff.parameters()]
    (j_loss,) = jdiff(x=jnp.asarray(x), T=T, loss_only=True)
    (t_loss,) = tdiff(x=torch.as_tensor(x), T=T, loss_only=True)
    assert _rel(t_loss.item(), float(j_loss)) <= LOSS_TOL
    assert t_loss.item() >= 0.0
    for a, b in zip(before, tdiff.parameters()):
        assert torch.equal(a, b)
        assert b.grad is None
    # the attached call's first step draws the same noise (count 0)
    tdiff.attach_optimizer(torch.optim.Adam(tdiff.parameters(), lr=LR))
    (first,) = tdiff(x=torch.as_tensor(x), T=T)
    assert first.item() == t_loss.item()


def test_loss_only_keeps_batchnorm_statistics():
    """A BatchNorm model's loss-only call (``QIDDM_L_B``, a BatchNorm
    before each block) matches JAX's and leaves every buffer as it was: the train-mode loss
    updates the running statistics, which JAX's loss-only call throws
    away, so sampling afterwards normalises as before."""
    from qiddm_tpu_torch import nn as tnn

    jnet = jnn.QIDDM_L_B(*MODEL, seed=3)
    assert "batch_stats" in jnet.variables
    tnet = tnn.QIDDM_L_B(*MODEL, device="cpu")
    tckpt.load_jax_variables(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.variables))
    jdiff = JDiffusion(jnet, shape=(8, 8)).train()
    tdiff = TDiffusion(tnet, _jax_key_noise, "data", (8, 8)).train()
    before = {k: b.clone() for k, b in tnet.named_buffers()}
    assert any("running" in k for k in before), sorted(before)
    x = _images(n=8, seed=10)
    (j_loss,) = jdiff(x=jnp.asarray(x), T=T, loss_only=True)
    (t_loss,) = tdiff(x=torch.as_tensor(x), T=T, loss_only=True)
    assert _rel(t_loss.item(), float(j_loss)) <= LOSS_TOL
    j_elem, _ = jdiff(x=jnp.asarray(x), T=T, loss_only=True, verbose=True)
    t_elem, _ = tdiff(x=torch.as_tensor(x), T=T, loss_only=True,
                      verbose=True)
    np.testing.assert_allclose(t_elem.numpy(), np.asarray(j_elem),
                               atol=LOSS_TOL)
    for k, b in tnet.named_buffers():
        assert torch.equal(b, before[k]), k
    want = jax.tree_util.tree_map(np.asarray, jnet.variables)
    got = tckpt.export_jax_variables(tnet)
    for col in ("batch_stats",):
        for path, leaf in jax.tree_util.tree_leaves_with_path(want[col]):
            np.testing.assert_array_equal(
                np.asarray(_at(got[col], path)), leaf, err_msg=str(path))


def _at(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def test_without_an_optimizer_the_call_raises():
    jdiff, tdiff = _pair()
    x = _images()
    with pytest.raises(RuntimeError, match="attach_optimizer"):
        jdiff(x=jnp.asarray(x), T=T)
    with pytest.raises(RuntimeError, match="attach_optimizer"):
        tdiff(x=torch.as_tensor(x), T=T)


def test_reference_loop_trains_one_step_a_call_as_make_train_step():
    """The outer ``opt.step()`` finds no gradient: parameters, Adam's
    state and losses equal ``make_train_step``'s on the same draws, bit for
    bit, and a second outer step moves nothing."""
    x = torch.as_tensor(_images(seed=8))
    nets = [QIDDM_LL_noise(*MODEL, seed=5, device="cpu") for _ in range(2)]
    call = TDiffusion(nets[0], shape=(8, 8)).train()
    opt = torch.optim.Adam(call.parameters(), lr=LR)
    call.attach_optimizer(opt)
    ref = TDiffusion(nets[1], shape=(8, 8))
    ref_opt = torch.optim.Adam(ref.parameters(), lr=LR)
    step = ref.make_train_step(ref_opt, T)
    for i in range(3):
        opt.zero_grad()
        (got,) = call(x=x, T=T)
        assert all(p.grad is None for p in call.parameters())
        opt.step()
        opt.step()  # a stray extra step moves nothing either
        want = step(x.reshape(len(x), -1), torch.Generator().manual_seed(i))
        assert got.item() == abs(want.item())
        for a, b in zip(call.parameters(), ref.parameters()):
            assert torch.equal(a, b)
    assert all(s["step"].item() == 3 for s in opt.state.values())


def test_explicit_generator_and_eval_mode():
    """A ``generator=`` stands where the JAX call takes ``key``; in eval
    mode the call samples from ``x``."""
    x = torch.as_tensor(_images(seed=9))
    net = QIDDM_LL_noise(*MODEL, seed=6, device="cpu")
    diff = TDiffusion(net, shape=(8, 8)).train()
    a = diff(x=x, T=T, loss_only=True,
             generator=torch.Generator().manual_seed(11))[0]
    b = diff(x=x, T=T, loss_only=True,
             generator=torch.Generator().manual_seed(11))[0]
    c = diff(x=x, T=T, loss_only=True)[0]
    assert a.item() == b.item() != c.item()
    diff.eval()
    got = diff(x=x, n_iters=2, only_last=True)
    want = diff.sample(n_iters=2, first_x=x, only_last=True)
    assert got.shape == x.shape and torch.equal(got, want)
    assert diff.forward(x=x, n_iters=1, only_last=True).shape == x.shape
