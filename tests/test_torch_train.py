"""The training half of qiddm_tpu_torch against qiddm_tpu on the CPU: noise
schedules, the tau-chain loss, model gradients, Adam, and the epoch loop.

The two packages draw from different RNGs, so every test hands both the
same draws: the port's schedules take the noise that ``jax.random`` draws
from the JAX key (``noise=``, or a ``noise_f`` that returns the injected
blend), and batch orders are given explicitly.

Tolerances:
* noise schedules and norms: <= 1e-6 (a few ulp of float32 blends);
* the tau-chain loss: <= 1e-5 relative; per-element terms <= 1e-5
  absolute (the forward of QIDDM_LL_noise(64, 3, 2, 2) through the gate
  chain here and per-layer or composed unitaries in JAX);
* model gradients: <= 1e-4 relative in the max norm, per parameter (a
  float32 backward through two independent formulations);
* torch Adam against optax Adam on the same gradients: <= 1e-6 relative;
* the loss trace over 3 Adam steps: <= 1e-3 relative. At step 1 Adam
  moves a parameter by ~lr * sign(g), so a gradient entry within float
  noise of zero could move it by up to 2 lr; the bound leaves room for
  that, and the measured trace agrees far closer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qiddm_tpu import nn as jnn
from qiddm_tpu import noise as jnoise
from qiddm_tpu.diffusion import Diffusion as JDiffusion
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch import noise as tnoise
from qiddm_tpu_torch import train as ttrain
from qiddm_tpu_torch.diffusion import Diffusion as TDiffusion
from qiddm_tpu_torch.nn import QIDDM_LL_noise

NOISE_TOL = 1e-6
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ADAM_TOL = 1e-6
TRACE_TOL = 1e-3
MODEL = (64, 3, 2, 2)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_draw(name, key, batch, pixels, tau):
    """The draw each JAX schedule makes from ``key`` (qiddm_tpu/noise.py)."""
    shape = (batch, pixels)
    if name == "add_normal_noise_multiple":
        return 0.5 + 0.2 * jax.random.normal(key, shape)
    if name == "add_uniform_noise_multiple":
        return jax.random.uniform(key, shape)
    keys = jax.random.split(key, tau - 1)
    fn = (jax.random.uniform if name == "add_uniform_noise_iteratively"
          else jax.random.normal)
    return jnp.stack([fn(k, shape) for k in keys])


@pytest.mark.parametrize("name", sorted(jnoise.SCHEDULES))
@pytest.mark.parametrize("decay_mod", [None, 3.0])
def test_schedules_match_jax_on_injected_draws(name, decay_mod):
    data = np.random.default_rng(0).uniform(size=(3, 64)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    tau = 6
    extra = () if decay_mod is None else (decay_mod,)
    want = jnoise.SCHEDULES[name](key, jnp.asarray(data), tau, *extra)
    noise = torch.as_tensor(np.asarray(_jax_draw(name, key, 3, 64, tau)))
    got = tnoise.SCHEDULES[name](None, torch.as_tensor(data), tau, *extra,
                                 noise=noise)
    assert got.shape == want.shape == (3 * tau, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=NOISE_TOL)


@pytest.mark.parametrize("name", sorted(tnoise.SCHEDULES))
def test_schedule_draws_follow_the_generator(name):
    data = torch.rand((2, 16), generator=torch.Generator().manual_seed(0))
    fn = tnoise.SCHEDULES[name]
    a = fn(torch.Generator().manual_seed(3), data, 4)
    b = fn(torch.Generator().manual_seed(3), data, 4)
    c = fn(torch.Generator().manual_seed(4), data, 4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # row 0 of each image's chain is the clean image
    torch.testing.assert_close(a.reshape(2, 4, 16)[:, 0], data)


def test_norms_match_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(4, 10)).astype(np.float32)
    x[2] = 0.0  # the clamp on an all-zero row
    for name in ("l1_norm", "l2_norm"):
        np.testing.assert_allclose(
            getattr(tnoise, name)(torch.as_tensor(x)).numpy(),
            np.asarray(getattr(jnoise, name)(jnp.asarray(x))),
            atol=NOISE_TOL)
    target = rng.uniform(size=(2, 10)).astype(np.float32)
    for shape in ((3, 2, 10), (6, 10)):
        inp = rng.uniform(size=shape).astype(np.float32)
        np.testing.assert_allclose(
            tnoise.normalize_mean(torch.as_tensor(target),
                                  torch.as_tensor(inp)).numpy(),
            np.asarray(jnoise.normalize_mean(jnp.asarray(target),
                                             jnp.asarray(inp))),
            atol=NOISE_TOL)


def _injecting(draws):
    """A ``noise_f`` that blends the given draws in turn, as the JAX
    schedule blends the draw of its key."""
    queue = list(draws)

    def noise_f(generator, data, tau, decay_mod):
        return tnoise.add_normal_noise_multiple(
            generator, data, tau, decay_mod,
            noise=torch.as_tensor(np.asarray(queue.pop(0))))

    return noise_f


def _pair(goal="data", seed=3):
    jnet = jnn.QIDDM_LL_noise(*MODEL, seed=seed)
    tnet = QIDDM_LL_noise(*MODEL, device="cpu")
    tckpt.load_jax_variables(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.variables))
    return (JDiffusion(jnet, prediction_goal=goal, shape=(8, 8)),
            tnet)


def _batch(n, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, 64)).astype(
        np.float32)


@pytest.mark.parametrize("goal", ["data", "noise"])
@pytest.mark.parametrize("padded", [False, True])
def test_chain_loss_matches_jax(goal, padded):
    jdiff, tnet = _pair(goal)
    x = _batch(3)
    valid = None
    if padded:
        x[2] = x[0]  # the dropless pad: a copy of row 0 at weight 0
        valid = np.array([1.0, 1.0, 0.0], np.float32)
    key = jax.random.PRNGKey(5)
    jloss, (jper, jrecon, _) = jdiff._chain_loss(
        jdiff.net.params, jdiff.net.extra_variables, key, jnp.asarray(x), 3,
        valid=None if valid is None else jnp.asarray(valid))
    draw = 0.5 + 0.2 * jax.random.normal(key, x.shape)
    tdiff = TDiffusion(tnet, _injecting([draw]), goal, (8, 8))
    tloss, (tper, trecon) = tdiff._chain_loss(
        torch.as_tensor(x), 3, generator=None,
        valid=None if valid is None else torch.as_tensor(valid))
    assert _rel_err(tloss.item(), float(jloss)) <= LOSS_TOL
    assert tper.shape == jper.shape == (9, 1, 8, 8)
    np.testing.assert_allclose(tper.detach().numpy(), np.asarray(jper),
                               atol=LOSS_TOL)
    np.testing.assert_allclose(trecon.detach().numpy(), np.asarray(jrecon),
                               atol=LOSS_TOL)


def _grads_by_flax_path(tnet):
    params = dict(tnet.module.named_parameters())
    return {path: (params[name].grad.numpy().T if transpose
                   else params[name].grad.numpy())
            for name, (path, transpose) in tckpt._flax_paths(tnet).items()}


@pytest.mark.parametrize("batch", [1, 3], ids=["gate_chain", "composed"])
def test_model_gradients_match_jax(batch):
    """batch * T = 3 rows < 2^3 runs the gate chain (its autograd Function
    on the CPU); 9 rows >= 2^3 the composed unitaries."""
    jdiff, tnet = _pair()
    x = _batch(batch, seed=2)
    key = jax.random.PRNGKey(9)

    def jloss(params):
        return jdiff._chain_loss(params, jdiff.net.extra_variables, key,
                                 jnp.asarray(x), 3)[0]

    jgrads = jax.grad(jloss)(jdiff.net.params)
    tdiff = TDiffusion(tnet, _injecting(
        [0.5 + 0.2 * jax.random.normal(key, x.shape)]), "data", (8, 8))
    tloss, _ = tdiff._chain_loss(torch.as_tensor(x), 3, generator=None)
    tloss.backward()
    got = _grads_by_flax_path(tnet)
    assert {p[1] for p in got} == {"linear_down", "qweights", "linear_up"}
    for path, g in got.items():
        want = jgrads
        for k in path[1:]:
            want = want[k]
        assert _rel_err(g, want) <= GRAD_TOL, path


def test_torch_adam_matches_optax_on_given_gradients():
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 5), "b": (7,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 10.0 ** -i
              for k, s in shapes.items()} for i in range(3)]
    opt = optax.adam(0.0255)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v))
          for k, v in params.items()}
    topt = torch.optim.Adam(list(tp.values()), lr=0.0255)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.as_tensor(g[k])
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=ADAM_TOL,
                                       atol=ADAM_TOL)


def test_loss_trace_over_adam_steps_matches_jax():
    jdiff, tnet = _pair()
    x = _batch(2, seed=6)
    keys = [jax.random.PRNGKey(20 + i) for i in range(3)]
    jstep = jdiff.make_train_step(optax.adam(0.0255), 3)
    params, extra = jdiff.net.params, jdiff.net.extra_variables
    opt_state = optax.adam(0.0255).init(params)
    want = []
    for key in keys:
        params, opt_state, extra, loss = jstep(params, opt_state, extra,
                                               key, jnp.asarray(x))
        want.append(float(loss))
    tdiff = TDiffusion(tnet, _injecting(
        [0.5 + 0.2 * jax.random.normal(k, x.shape) for k in keys]),
        "data", (8, 8))
    tstep = tdiff.make_train_step(
        torch.optim.Adam(tdiff.parameters(), lr=0.0255), 3)
    got = [tstep(torch.as_tensor(x)).item() for _ in keys]
    assert _rel_err(got, want) <= TRACE_TOL, (got, want)


def _row_noise(generator, data, tau, decay_mod):
    """Noise that depends only on each row, so a row's loss does not depend
    on what else is in its batch."""
    return tnoise.add_normal_noise_multiple(
        generator, data, tau, decay_mod, noise=0.5 + 0.2 * torch.sin(7 * data))


def test_epoch_losses_sum_batch_means_with_a_padded_last_batch():
    tnet = QIDDM_LL_noise(*MODEL, seed=1, device="cpu")
    diff = TDiffusion(tnet, _row_noise, "data", (8, 8))
    x = torch.as_tensor(_batch(5, seed=3))
    # lr 0: the parameters stay put, so each batch's loss can be recomputed
    run = diff.make_multi_epoch_fn(torch.optim.Adam(diff.parameters(), lr=0.0),
                                   3, 2, 2)
    order = torch.tensor([[3, 1], [4, 0], [2, -1], [0, 2], [1, 3], [4, -1]])
    got = run(None, x, 5, batches=order)
    with torch.no_grad():
        per_batch = [diff._chain_loss(x[idx[idx >= 0]], 3,
                                      generator=None)[0].item()
                     for idx in order]
    want = [sum(per_batch[:3]), sum(per_batch[3:])]
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_TOL)
    drawn = run(torch.Generator().manual_seed(0), x, 5)
    assert drawn.shape == (2,) and torch.isfinite(drawn).all()


def test_padded_rows_carry_no_gradient():
    tnet = QIDDM_LL_noise(*MODEL, seed=1, device="cpu")
    diff = TDiffusion(tnet, _row_noise, "data", (8, 8))
    x = torch.as_tensor(_batch(2, seed=4))
    grads = []
    for rows, valid in ((x[[1, 0]], torch.tensor([1.0, 0.0])),
                        (x[[1]], None)):
        tnet.zero_grad()
        diff._chain_loss(rows, 3, generator=None, valid=valid)[0].backward()
        grads.append([p.grad.clone() for p in tnet.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_train_diffusion_scan_warmup_restarts_from_the_same_state():
    x = _batch(4, seed=5)
    out = []
    for warmup in (False, True):
        tnet = QIDDM_LL_noise(*MODEL, seed=2, device="cpu")
        diff = TDiffusion(tnet, shape=(8, 8))
        losses, wall, state = ttrain.train_diffusion_scan(
            diff, x, epochs=2, batch_size=2, lr=0.0255, T=3, key=11,
            warmup=warmup, return_opt_state=True)
        assert wall > 0 and losses.shape == (2,)
        assert all(s["step"].item() == 4 for s in state["state"].values())
        out.append((losses, tckpt.export_jax_variables(tnet)))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    for a, b in zip(jax.tree_util.tree_leaves(out[0][1]),
                    jax.tree_util.tree_leaves(out[1][1])):
        np.testing.assert_array_equal(a, b)


def test_train_diffusion_resumes_at_start_epoch():
    x = _batch(4, seed=5)
    tnet = QIDDM_LL_noise(*MODEL, seed=2, device="cpu")
    diff = TDiffusion(tnet, shape=(8, 8))
    losses = ttrain.train_diffusion(diff, x, epochs=3, batch_size=3,
                                    lr=0.0255, T=3, key=1, start_epoch=1)
    assert len(losses) == 2 and all(np.isfinite(losses))
    with pytest.raises(NotImplementedError, match="item 11"):
        ttrain.train_diffusion_scan(diff, x, epochs=1, batch_size=2,
                                    lr=0.1, T=3, mesh=object())
