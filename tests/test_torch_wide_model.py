"""The wide (11-20 wire) slice as a whole against qiddm_tpu on the CPU: the
engine's re-uploading block at 11 and 13 wires (probs and PauliZ
readouts, values and gradients) and QIDDM_LL_noise(64, 11, 2, 2) with the
JAX variables carried across by ``load_jax_variables``: one training
step's loss and gradients, and 2 sampling iterations.

The JAX package runs these widths on the CPU through its gate-level scan
(``sel_apply_gates``), the port through the grouped wide chain's plain
versions: independent formulations. Tolerances: the block's outputs
<= 1e-5 absolute and its gradients <= 2e-5 (tests/test_wide_kernel.py's),
the model's loss and each parameter's gradient <= 1e-4 relative (max
norm), the sampled images <= 1e-4 absolute, as for the narrower slices
(tests/test_torch_train.py, tests/test_torch_sample.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import nn as jnn
from qiddm_tpu.diffusion import Diffusion as JDiffusion
from qiddm_tpu.sim import engine as jengine
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch import noise as tnoise
from qiddm_tpu_torch.diffusion import Diffusion as TDiffusion
from qiddm_tpu_torch.nn import QIDDM_LL_noise
from qiddm_tpu_torch.sim import engine as tengine
from qiddm_tpu_torch.sim import wide_kernel

BLOCK_TOL = 1e-5
BLOCK_GRAD_TOL = 2e-5
MODEL_TOL = 1e-4
MODEL = (64, 11, 2, 2)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("readout", ["probs", "expvalz"])
@pytest.mark.parametrize("w,encode", [(11, "rz"), (13, "rz_halfpi")])
def test_reupload_block_matches_jax_engine(w, encode, readout):
    rng = np.random.default_rng(w)
    x = rng.normal(size=(3, w)).astype(np.float32)
    wq = (rng.normal(size=(2, 2, w, 3)) * 0.5).astype(np.float32)
    weight = rng.normal(size=(2**w if readout == "probs" else w,)).astype(
        np.float32)

    def jloss(x, wq):
        out = jengine.reupload_block(x, wq, encode=encode, readout=readout)
        return jnp.sum(out * weight), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1),
                                           has_aux=True)(jnp.asarray(x),
                                                         jnp.asarray(wq))
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(wq).requires_grad_(True)
    before = wide_kernel.WIDE_LAUNCHES
    out = tengine.reupload_block(xt, wt, encode=encode, readout=readout)
    (out * torch.as_tensor(weight)).sum().backward()
    assert wide_kernel.WIDE_LAUNCHES == before  # plain on the CPU
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=BLOCK_TOL)
    for got, want in zip((xt.grad, wt.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=BLOCK_GRAD_TOL)


@pytest.fixture(scope="module")
def nets():
    jnet = jnn.QIDDM_LL_noise(*MODEL, seed=5)
    tnet = QIDDM_LL_noise(*MODEL, device="cpu")
    tckpt.load_jax_variables(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.variables))
    return jnet, tnet


def _grads_by_flax_path(tnet):
    params = dict(tnet.module.named_parameters())
    return {path: (params[name].grad.numpy().T if transpose
                   else params[name].grad.numpy())
            for name, (path, transpose) in tckpt._flax_paths(tnet).items()}


def test_training_step_matches_jax(nets):
    """One tau-3 chain loss and its gradients: 3 rows of 11 wires, well
    below 2^11, so both blocks run the wide chain."""
    jnet, tnet = nets
    jdiff = JDiffusion(jnet, prediction_goal="data", shape=(8, 8))
    x = np.random.default_rng(2).uniform(size=(1, 64)).astype(np.float32)
    key = jax.random.PRNGKey(9)

    def jloss(params):
        return jdiff._chain_loss(params, jdiff.net.extra_variables, key,
                                 jnp.asarray(x), 3)[0]

    want_loss, jgrads = jax.value_and_grad(jloss)(jdiff.net.params)
    draw = np.array(0.5 + 0.2 * jax.random.normal(key, x.shape))

    def noise_f(generator, data, tau, decay_mod):
        return tnoise.add_normal_noise_multiple(
            generator, data, tau, decay_mod, noise=torch.as_tensor(draw))

    tnet.zero_grad()
    tdiff = TDiffusion(tnet, noise_f, "data", (8, 8))
    tloss, _ = tdiff._chain_loss(torch.as_tensor(x), 3, generator=None)
    tloss.backward()
    assert _rel_err(tloss.item(), float(want_loss)) <= MODEL_TOL
    got = _grads_by_flax_path(tnet)
    assert {p[1] for p in got} == {"linear_down", "qweights", "linear_up"}
    for path, g in got.items():
        want = jgrads
        for k in path[1:]:
            want = want[k]
        assert _rel_err(g, want) <= MODEL_TOL, path
    tnet.zero_grad()


def test_sampling_matches_jax(nets):
    jnet, tnet = nets
    first_x = (np.random.default_rng(1).uniform(size=(2, 1, 8, 8))
               * 0.75 + 0.5).astype(np.float32)
    want = np.asarray(JDiffusion(jnet, shape=(8, 8)).eval().sample(
        n_iters=2, first_x=jnp.asarray(first_x), only_last=True))
    with torch.no_grad():
        got = TDiffusion(tnet, shape=(8, 8)).eval().sample(
            n_iters=2, first_x=torch.as_tensor(first_x),
            only_last=True).numpy()
    assert got.shape == want.shape == (2, 1, 8, 8)
    np.testing.assert_allclose(got, want, atol=MODEL_TOL)
    assert TDiffusion(tnet).save_name() == "QIDDM_LL_noise=11_L=2_N=2"


def test_clis_take_the_16_wire_model(tmp_path):
    """The CLIs cap no width: ``QIDDM_LL_noise 784 16 14 2`` builds,
    passes mnist_exm's validation, its checkpoint name
    ``QIDDM_LL_noise=16_L=14_N=2`` round-trips through the port's
    checkpoint and the JAX package's, and the sampling CLI serves it on
    the CPU."""
    from qiddm_tpu import ckpt as jckpt
    from qiddm_tpu_torch.cli import common, mnist_exm
    from qiddm_tpu_torch.cli import sample as tsample

    margs = ["QIDDM_LL_noise", "784", "16", "14", "2"]
    common.validate_args(mnist_exm.parse_args(
        ["--model", *margs, "--device", "cpu"]))
    net = common.build_model(margs, seed=3, device="cpu")
    assert net.save_name() == "QIDDM_LL_noise=16_L=14_N=2"
    assert tuple(net.module.qweights.shape) == (2, 14, 2, 16, 3)
    ck = tckpt.save_checkpoint(tmp_path / f"{net.save_name()}_4.pt",
                               tckpt.export_jax_variables(net), [0.5], 1)
    blob = jckpt.load_checkpoint(ck)
    back = common.build_model(margs, seed=4, device="cpu")
    tckpt.load_jax_variables(back, blob["model_state_dict"])
    for (name, p), (_, q) in zip(net.named_parameters(),
                                 back.named_parameters()):
        assert torch.equal(p, q), name
    imgs = tsample.main(["--ckpt", str(ck), "--model", *margs, "--n", "1",
                         "--iters", "1", "--device", "cpu", "--out",
                         str(tmp_path / "out")])
    assert imgs.shape == (1, 1, 28, 28) and np.isfinite(imgs).all()
