"""Proximal operators.

PyTorch port of ``elemental_tpu/optimization/prox.py`` (Elemental
``src/optimization/prox/**``: ``SoftThreshold.cpp``, ``SVT.cpp``
(``svt::Normal``), ``Clip.cpp``, ``FrobeniusProx.cpp``,
``HingeLossProx.cpp``, ``LogisticProx.cpp``).

All elementwise operators run directly on [MC,MR] storage (each entry
once, padding zero preserved since every operator maps 0 -> 0 or is
masked); SVT rides the distributed SVD, and with it the ``qr_panel`` and
``potrf_inv`` kernels of its QDWH polar step on the card.
"""
from __future__ import annotations

import torch

from ..core.dist import STAR
from ..core.distmatrix import DistMatrix
from ..blas.level1 import _valid_mask, diagonal_scale
from ..blas.level3 import gemm


def soft_threshold(A: DistMatrix, tau) -> DistMatrix:
    """prox_{tau ||.||_1}: sign(a) max(|a| - tau, 0) (``El::SoftThreshold``)."""
    a = A.local
    mag = torch.clamp_min(a.abs() - tau, 0)
    phase = torch.where(a.abs() == 0, 0, a / torch.where(a == 0, 1, a.abs()))
    return A.with_local(phase * mag)


def clip(A: DistMatrix, lo, hi) -> DistMatrix:
    """Entrywise clamp to [lo, hi] on the valid region (``El::Clip``)."""
    out = torch.clamp(A.local, lo, hi)
    return A.with_local(torch.where(_valid_mask(A), out, 0))


def frobenius_prox(A: DistMatrix, rho) -> DistMatrix:
    """prox_{rho ||.||_F}: scale toward zero (``El::FrobeniusProx``)."""
    nrm = torch.linalg.vector_norm(A.local)
    scale = torch.clamp_min(1 - rho / torch.clamp_min(nrm, 1e-300), 0)
    return A.with_local(scale * A.local)


def hinge_loss_prox(A: DistMatrix, rho) -> DistMatrix:
    """prox of the hinge loss sum max(1 - a, 0) (``El::HingeLossProx``)."""
    a = A.local
    out = torch.where(a < 1 - 1 / rho, a + 1 / rho,
                      torch.where(a > 1, a, 1.0))
    return A.with_local(torch.where(_valid_mask(A), out, 0))


def logistic_prox(A: DistMatrix, rho, newton_iters: int = 8) -> DistMatrix:
    """prox of sum log(1 + e^{-a}) via elementwise Newton
    (``El::LogisticProx``)."""
    a = A.local
    x = torch.clamp_min(a, 0.0)
    for _ in range(newton_iters):
        sig = 1.0 / (1.0 + torch.exp(-x))
        f = rho * (x - a) + sig - 1.0          # d/dx [rho/2 (x-a)^2 + log1pexp(-x)]
        fp = rho + sig * (1 - sig)
        x = x - f / fp
    return A.with_local(torch.where(_valid_mask(A), x, 0))


def svt(A: DistMatrix, tau, nb: int | None = None, precision=None,
        eig_approach: str = "tridiag") -> DistMatrix:
    """Singular-value thresholding prox_{tau ||.||_*} (``El::SVT``,
    ``svt::Normal``): U max(s - tau, 0) V^H via the distributed SVD."""
    from ..lapack.spectral import svd
    U, s, V = svd(A, nb=nb, precision=precision, eig_approach=eig_approach)
    st = torch.clamp_min(s - tau, 0).to(A.dtype)
    d = DistMatrix(st[:, None], (st.shape[0], 1), STAR, STAR, 0, 0, A.grid)
    Us = diagonal_scale("R", d, U)
    return gemm(Us, V, orient_b="C", nb=nb, precision=precision)
