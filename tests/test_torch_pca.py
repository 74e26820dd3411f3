"""qiddm_tpu_torch.pca against qiddm_tpu.pca on the CPU: the same numpy
batches through both packages, in both branches of the fit (the Gram
matrix when the batch has at most as many rows as features, the covariance
matrix otherwise).

Tolerances: the mean to 1e-6; each component, a unit vector from ``eigh``
in float32 through two LAPACK calls, to 1e-5 (measured ~1.5e-6); the
projections (up to ~3 in size: 64 features in [0, 1)) and their inverse to
5e-5 absolute. The parity batches hold at least n_components + 2 rows: at
fewer, a null-space eigenpair's fate under the 1e-4 zeroing rule depends on
rounding, so the padding and the zeroing are checked on rows that are well
defined instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import pca as jpca
from qiddm_tpu_torch import pca as tpca

MEAN_TOL = 1e-6
COMP_TOL = 1e-5
PROJ_TOL = 5e-5


def _batch(b, d, seed=0):
    return np.random.default_rng(seed).uniform(size=(b, d)).astype(np.float32)


# (rows, features, components): Gram branch for rows <= features
@pytest.mark.parametrize("b,d,n", [(10, 64, 8), (12, 64, 8), (64, 64, 4),
                                   (80, 64, 8), (200, 16, 4)],
                         ids=["gram10", "gram12", "gram_square", "cov80x64",
                              "cov200x16"])
def test_fit_transform_and_inverse_match_jax(b, d, n):
    x = _batch(b, d, seed=b)
    jst, jy = jpca.pca_fit_transform(jnp.asarray(x), n)
    tst, ty = tpca.pca_fit_transform(torch.as_tensor(x), n)
    assert tst.components.shape == (n, d) and ty.shape == (b, n)
    np.testing.assert_allclose(tst.mean.numpy(), np.asarray(jst.mean),
                               atol=MEAN_TOL)
    np.testing.assert_allclose(tst.components.numpy(),
                               np.asarray(jst.components), atol=COMP_TOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=PROJ_TOL)
    back = tpca.pca_inverse_transform(tst, ty)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jpca.pca_inverse_transform(jst, jy)),
        atol=PROJ_TOL)


def test_sign_convention_matches_jax():
    """svd_flip: the largest-magnitude entry of each component is positive,
    and a tie takes the first entry, in both packages."""
    vt = np.array([[0.5, -0.5, 0.1], [-0.2, 0.9, -0.9], [0.0, -0.3, 0.3]],
                  np.float32)
    got = tpca._svd_flip_signs(torch.as_tensor(vt)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jpca._svd_flip_signs(jnp.asarray(vt))))
    np.testing.assert_array_equal(got, [1.0, 1.0, -1.0])
    st = tpca.pca_fit(torch.as_tensor(_batch(12, 64)), 8)
    comps = st.components.numpy()
    top = comps[np.arange(8), np.abs(comps).argmax(axis=1)]
    assert (top > 0).all()


def test_fewer_rows_than_components_pads_with_zeros():
    """3 rows, 5 components: k_eff = 3, so rows 3 and 4 are zero padding;
    the two rows the centred batch spans agree with JAX."""
    x = _batch(3, 64, seed=3)
    want = np.asarray(jpca.pca_fit(jnp.asarray(x), 5).components)
    got = tpca.pca_fit(torch.as_tensor(x), 5).components.numpy()
    assert got.shape == (5, 64)
    np.testing.assert_allclose(got[:2], want[:2], atol=COMP_TOL)
    assert not got[3:].any() and not want[3:].any()


def test_null_space_rows_are_zeroed():
    """In float64 a null-space eigenvalue is ~1e-16 of the largest, far
    below the 1e-4 threshold on the singular values: 4 rows of which two
    repeat span 2 centred directions, so components 2 and 3 are zero, and
    components 0 and 1 are numpy's SVD under sklearn's sign convention."""
    x = _batch(3, 16, seed=4).astype(np.float64)
    x = np.concatenate([x, x[:1]])
    st = tpca.pca_fit(torch.as_tensor(x), 4)
    comps = st.components.numpy()
    assert not comps[2:].any()
    _, _, vt = np.linalg.svd(x - x.mean(axis=0), full_matrices=False)
    vt = vt[:2] * np.sign(vt[np.arange(2), np.abs(vt[:2]).argmax(axis=1)])[
        :, None]
    np.testing.assert_allclose(comps[:2], vt, atol=1e-12)


def test_fit_stops_the_gradient_like_jax():
    """The fit is a constant: the gradient reaches the batch through the
    projection alone, in both packages."""
    x = _batch(12, 64, seed=5)
    xt = torch.as_tensor(x).requires_grad_(True)
    st, y = tpca.pca_fit_transform(xt, 8)
    assert not st.components.requires_grad and not st.mean.requires_grad
    (y ** 2).sum().backward()
    want = jax.grad(lambda v: (jpca.pca_fit_transform(v, 8)[1] ** 2).sum())(
        jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                               atol=PROJ_TOL)
