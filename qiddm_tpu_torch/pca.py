"""PCA with sklearn's conventions (counterpart of ``qiddm_tpu/pca.py``).

The PCA-down models project each image batch onto its principal components
before the quantum encode, re-fitting on every forward batch (reference
nn/qdense.py:456). This reproduces sklearn's ``fit_transform`` /
``transform`` / ``inverse_transform``, including the ``svd_flip`` sign
convention, through ``eigh`` of the smaller of the Gram and covariance
matrices, as the JAX package does. The fit runs under ``no_grad`` on a
detached input (the JAX package's ``stop_gradient``, the reference's
numpy round trip); :func:`pca_transform` stays differentiable.

The fit runs on the input's device: on a CUDA tensor ``torch.linalg.eigh``
is cuSOLVER's, which waits for the card once per fit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PCAState(NamedTuple):
    mean: torch.Tensor        # (D,)
    components: torch.Tensor  # (k, D)


def _svd_flip_signs(vt: torch.Tensor) -> torch.Tensor:
    """sklearn ``svd_flip(u, v, u_based_decision=False)``: the sign of the
    largest-magnitude entry of each row of Vt (the first one on a tie)."""
    idx = torch.argmax(vt.abs(), dim=1)
    vals = torch.gather(vt, 1, idx[:, None])[:, 0]
    return torch.where(vals >= 0, 1.0, -1.0).to(vt.dtype)


def _eigh_descending(a: torch.Tensor, n: int):
    """The ``n`` largest eigenpairs of the symmetric ``a``, largest first.
    ``a`` is symmetrised first and ties keep eigh's ascending order, as
    ``jnp.linalg.eigh`` and JAX's stable ``argsort`` do."""
    evals, evecs = torch.linalg.eigh(0.5 * (a + a.T))  # ascending
    order = torch.argsort(-evals, stable=True)[:n]
    return evals[order], evecs[:, order]


@torch.no_grad()
def pca_fit(x: torch.Tensor, n_components: int) -> PCAState:
    """Fit PCA on ``x`` (B, D); no gradient flows through the fit."""
    x = x.detach()
    b, d = x.shape
    mean = x.mean(dim=0)
    xc = x - mean
    if b <= d:
        # Gram trick: eigh of (B, B). A batch of fewer rows than components
        # (where sklearn would refuse) gets zero-padded trailing components,
        # so the shapes downstream stay fixed.
        k_eff = min(n_components, b)
        evals, u = _eigh_descending(xc @ xc.T, k_eff)
        s = torch.sqrt(torch.clamp(evals, min=0.0))
        vt = ((xc.T @ u) / torch.clamp(s[None, :], min=1e-12)).T  # (k_eff, D)
        components = vt * _svd_flip_signs(vt)[:, None]
        # null-space eigenpairs (s ~ 0) give rows of rounding noise / 1e-12:
        # zeroed, the same convention as the padding below
        s_tol = s.max() * 1e-4 + 1e-12
        components = torch.where((s > s_tol)[:, None], components, 0.0)
        if k_eff < n_components:
            components = torch.cat(
                [components, components.new_zeros((n_components - k_eff, d))])
    else:
        _, v = _eigh_descending(xc.T @ xc, n_components)  # (D, k)
        vt = v.T
        components = vt * _svd_flip_signs(vt)[:, None]
    return PCAState(mean=mean, components=components)


def pca_transform(state: PCAState, x: torch.Tensor) -> torch.Tensor:
    return (x - state.mean[None, :]) @ state.components.T


def pca_inverse_transform(state: PCAState, y: torch.Tensor) -> torch.Tensor:
    return y @ state.components + state.mean[None, :]


def pca_fit_transform(x: torch.Tensor, n_components: int):
    state = pca_fit(x, n_components)
    return state, pca_transform(state, x)
