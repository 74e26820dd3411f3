"""The reference's torch ``.pt`` checkpoints in qiddm_tpu_torch against
qiddm_tpu on the CPU: ``export_torch_state_dict``, ``import_torch_state_dict``,
``save_reference_checkpoint`` and ``load_reference_checkpoint``.

Both packages hold the same weights (the JAX model's variables carried into
the port by ``load_jax_variables``); the reference state dicts must then be
equal key for key and value for value, exactly: the port maps the same flax
tree with the same rules. A ``.pt`` written by either package, loaded by the
other, gives equal variables; strict mode rejects a tensor the mapping does
not consume. The PCA-holding class pickles an sklearn PCA beside the
weights, and the reader unpickles it only for a model that holds one.
"""

import jax
import numpy as np
import pytest
import torch

from qiddm_tpu import ckpt as jckpt
from qiddm_tpu import nn as jnn
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch import nn as tnn

# (class, small ctor args, ctor keywords)
MODELS = [
    ("QIDDM_LL_noise", (64, 3, 1, 1), {}),
    ("QNN_noise", (64, 3, 2), {}),
    ("QDenseUndirected_old_noise", (2, 8), {}),
    ("QIDDM_PL_noise1", (64, 4, 2, 2), {}),
    ("differN_noise", (8, 2, 2), {}),
    ("UNetUndirected", (2, 2, 1), {"img_shape": (8, 8)}),
    ("UNetUndirected", (2, 2, 0), {"img_shape": (8, 8)}),
    # the PCA-holding class: a pickled sklearn PCA rides along
    ("QIDDM_PP_old", (64, 4, 2, 2), {}),
]
IDS = ["QIDDM_LL_noise", "QNN_noise", "QDenseUndirected_old_noise",
       "QIDDM_PL_noise1", "differN_noise", "UNetUndirected_q",
       "UNetUndirected_c", "QIDDM_PP_old"]


def _tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _stats_moved(tree):
    """BatchNorm statistics away from their init values, so a swapped
    mean and var would show."""
    rng = np.random.default_rng(5)
    for path, leaf in tckpt._flatten(tree.get("batch_stats", {})).items():
        node = tree["batch_stats"]
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = rng.uniform(0.5, 2.0, np.shape(leaf)).astype(
            np.float32)
    return tree


def _pair(name, args, kw):
    """The JAX model and a port model holding the same variables."""
    jnet = getattr(jnn, name)(*args, seed=3, **kw)
    jnet.variables = _stats_moved(_tree(jnet.variables))
    tnet = getattr(tnn, name)(*args, seed=11, device="cpu", **kw)
    tckpt.load_jax_variables(tnet, _tree(jnet.variables))
    return jnet, tnet


def _assert_trees_equal(a, b):
    fa, fb = tckpt._flatten(a), tckpt._flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg="/".join(k))


@pytest.mark.parametrize("name,args,kw", MODELS, ids=IDS)
def test_export_equals_the_jax_export(name, args, kw):
    jnet, tnet = _pair(name, args, kw)
    for prefix in ("net.", ""):
        want = jckpt.export_torch_state_dict(jnet, prefix=prefix)
        got = tckpt.export_torch_state_dict(tnet, prefix=prefix)
        assert list(got) == list(want)
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (tckpt._reference_weights_key(tnet)
            == jckpt._reference_weights_key(jnet))


@pytest.mark.parametrize("name,args,kw", MODELS, ids=IDS)
def test_pt_written_by_each_package_loads_in_the_other(tmp_path, name, args,
                                                       kw):
    jnet, tnet = _pair(name, args, kw)
    # the port writes, the JAX package reads
    tpath = tckpt.save_reference_checkpoint(tnet, tmp_path / "port.pt",
                                            [0.5, 0.25], 2)
    jback = getattr(jnn, name)(*args, seed=17, **kw)
    assert jckpt.load_reference_checkpoint(jback, tpath) == ([0.5, 0.25], 2)
    _assert_trees_equal(_tree(jback.variables), _tree(jnet.variables))
    # the JAX package writes, the port reads
    jpath = jckpt.save_reference_checkpoint(jnet, tmp_path / "jax.pt",
                                            [0.75], 1)
    tback = getattr(tnn, name)(*args, seed=19, device="cpu", **kw)
    assert tckpt.load_reference_checkpoint(tback, jpath) == ([0.75], 1)
    _assert_trees_equal(tckpt.export_jax_variables(tback),
                        _tree(jnet.variables))
    # and the same files' dicts are the same, key for key
    tsd = torch.load(tpath, weights_only=True)["model_state_dict"]
    jsd = torch.load(jpath, weights_only=True)["model_state_dict"]
    assert list(tsd) == list(jsd)
    for k in tsd:
        assert torch.equal(tsd[k], jsd[k]), k


def test_pca_state_is_a_pickled_sklearn_pca(tmp_path):
    """QIDDM_PP_old's fitted PCA travels as the reference's pickled
    sklearn PCA; a model without a PCA state leaves the blob alone."""
    from sklearn.decomposition import PCA

    jnet, tnet = _pair(*MODELS[-1])
    path = tckpt.save_reference_checkpoint(tnet, tmp_path / "pp.pt")
    blob = torch.load(path, weights_only=True)
    assert isinstance(blob["pca_state"], bytes)
    import pickle

    obj = pickle.loads(blob["pca_state"])
    assert isinstance(obj, PCA)
    want = _tree(jnet.variables)["pca_state"]
    np.testing.assert_array_equal(obj.components_.astype(np.float32),
                                  want["components"])
    # the same weights without the PCA: QIDDM_LL_noise ignores the blob
    other = tnn.QIDDM_LL_noise(64, 3, 1, 1, device="cpu")
    sd = tckpt.export_torch_state_dict(other)
    torch.save({"model_state_dict": {k: torch.as_tensor(v)
                                     for k, v in sd.items()},
                "pca_state": blob["pca_state"]}, tmp_path / "ll.pt")
    fresh = tnn.QIDDM_LL_noise(64, 3, 1, 1, seed=4, device="cpu")
    tckpt.load_reference_checkpoint(fresh, tmp_path / "ll.pt")
    _assert_trees_equal(tckpt.export_jax_variables(fresh),
                        tckpt.export_jax_variables(other))


def test_pca_without_sklearn_raises_naming_it(tmp_path, monkeypatch):
    import sys

    _, tnet = _pair(*MODELS[-1])
    monkeypatch.setitem(sys.modules, "sklearn.decomposition", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        tckpt.save_reference_checkpoint(tnet, tmp_path / "pp.pt")


def test_strict_rejects_an_unknown_key():
    jnet, tnet = _pair(*MODELS[0])
    sd = tckpt.export_torch_state_dict(tnet)
    sd["net.stray.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unmapped reference tensors"):
        tckpt.import_torch_state_dict(tnet, sd)
    with pytest.raises(ValueError, match="unmapped reference tensors"):
        jckpt.import_torch_state_dict(jnet, sd)
    # non-strict: the known tensors load, the stray one is dropped
    fresh = tnn.QIDDM_LL_noise(64, 3, 1, 1, seed=4, device="cpu")
    tckpt.import_torch_state_dict(fresh, sd, strict=False)
    _assert_trees_equal(tckpt.export_jax_variables(fresh),
                        _tree(jnet.variables))
