"""QIDDM-A, ``differN_noise(28, 9, 2)`` — the JAX bench's reference model
(bench.py's ``bench_qiddm_a``: 10 wires, L 9 and N 2, so L*k = 18 gate
layers a block) — at full width in qiddm_tpu_torch against qiddm_tpu on
the CPU, with the JAX weights carried across by ``load_jax_variables``:
the clean forward at the training batch (8 images x tau 10 = 80 rows),
one training step at batch 8, tau 10 against ``jax.grad``, and sampling a
batch of 16 step by step. Below 2^10 rows the port runs the gate chain's
plain version (kernels #1/#2 on the card) and the JAX package its gate
chain.

Each forward refits the PCA on its batch (80 or 16 rows, 10 components).
The training images are distinct and scaled by 0.7^j, so the chains'
leading directions have distinct variances and the 10 components are not
left to rounding (see tests/test_torch_pl_models.py).

Tolerances as tests/test_torch_pl_models.py: images 1e-4, the loss 1e-5
relative, each gradient within 1e-4 of its own max norm, ``qweights`` a
block at a time.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import nn as jnn
from qiddm_tpu.diffusion import Diffusion as JDiffusion
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch import nn as tnn
from qiddm_tpu_torch import noise as tnoise
from qiddm_tpu_torch.diffusion import Diffusion as TDiffusion

IMAGE_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ARGS = (28, 9, 2)
BATCH, TAU = 8, 10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread per test process: a thread pool in each oversubscribes
    the cores beside the other workers. One thread gives the same
    results."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _pair():
    jnet = jnn.differN_noise(*ARGS, seed=3)
    tnet = tnn.differN_noise(*ARGS, seed=5, device="cpu")
    tckpt.load_jax_variables(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.variables))
    return jnet, tnet


def _digits(n, seed):
    """``n`` distinct images in [0, 1], image j scaled by 0.7^j."""
    x = np.random.default_rng(seed).uniform(size=(n, 784)) ** 3
    return (x * 0.7 ** np.arange(n)[:, None]).astype(np.float32)


def test_shape_of_the_model():
    jnet, tnet = _pair()
    assert tnet.wires == 10 and tnet.spectrum_layer == 9 and tnet.N == 2
    assert tuple(tnet.module.qweights.shape) == (2, 9, 2, 10, 3)
    assert tnet.save_name() == jnet.save_name()
    assert tnet.num_params() == jnet.num_params() == 2 * 9 * 2 * 10 * 3


def test_clean_forward_at_the_training_batch():
    """80 rows (8 images x tau 10), the training step's batch."""
    jnet, tnet = _pair()
    img = _digits(BATCH * TAU, 0).reshape(-1, 1, 28, 28)
    want = np.asarray(jnet(img))
    with torch.no_grad():
        got = tnet(torch.as_tensor(img)).numpy()
    assert got.shape == want.shape == (80, 1, 28, 28)
    np.testing.assert_allclose(got, want, atol=IMAGE_TOL)


def test_training_step_matches_jax_grad():
    """One loss at batch 8, tau 10 (the bench's), its gradient against
    ``jax.grad``; the JAX schedule's noise draw blended on both sides."""
    jnet, tnet = _pair()
    x = _digits(BATCH, 1)
    key = jax.random.PRNGKey(11)
    jdiff = JDiffusion(jnet, prediction_goal="data", shape=(28, 28))

    def jloss(params):
        return jdiff._chain_loss(params, jnet.extra_variables, key,
                                 jnp.asarray(x), TAU)[0]

    want_loss, jgrads = jax.value_and_grad(jloss)(jnet.params)
    draw = np.array(0.5 + 0.2 * jax.random.normal(key, x.shape))

    def noise_f(generator, data, tau, decay_mod):
        return tnoise.add_normal_noise_multiple(
            generator, data, tau, decay_mod, noise=torch.as_tensor(draw))

    tdiff = TDiffusion(tnet, noise_f, "data", (28, 28))
    tnet.zero_grad()
    tloss, _ = tdiff.loss_fn(torch.as_tensor(x), TAU)
    tloss.backward()
    assert abs(tloss.item() - float(want_loss)) <= LOSS_TOL * abs(
        float(want_loss))
    got = tnet.module.qweights.grad.numpy()
    want = np.asarray(jgrads["qweights"])
    for n in range(2):
        scale = np.abs(want[n]).max()
        assert scale > 0, n
        err = np.abs(got[n] - want[n]).max()
        assert err <= GRAD_TOL * scale, (n, err, scale)


def test_sampling_matches_jax_step_by_step():
    """A batch of 16 (the sampler's), three iterations, each from JAX's
    batch; free-running PCA sampling drifts apart (ROADMAP Queue 3)."""
    jnet, tnet = _pair()
    first_x = (np.random.default_rng(2).uniform(size=(16, 1, 28, 28)) * 0.75
               + 0.5).astype(np.float32)
    stack = np.array(JDiffusion(jnet).sample_stack_fn(
        jnet.variables, jnp.asarray(first_x), 3))
    tdiff = TDiffusion(tnet, shape=(28, 28))
    for t in range(3):
        got = tdiff.sample_stack_fn(torch.as_tensor(stack[t]), 1)[1].numpy()
        np.testing.assert_allclose(got, stack[t + 1], atol=IMAGE_TOL,
                                   err_msg=f"iteration {t + 1}")
