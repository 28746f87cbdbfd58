"""Matrix properties: determinant, condition, inertia, norm estimates.

PyTorch port of ``elemental_tpu/lapack/props.py`` (Elemental
``src/lapack_like/props/``: ``Determinant.cpp`` with ``SafeDeterminant``
via LU and the pivot sign, ``Condition.cpp``, ``Inertia.cpp`` via the
pivoted LDL, ``TwoNormEstimate.cpp`` by power iteration, and the
Schatten norms through the SVD).  Scalars come back as 0-dim tensors on
the grid's device, the integer results as Python ints.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dist import MC, MR
from ..core.distmatrix import DistMatrix, from_global
from ..blas.level1 import (frobenius_norm, one_norm, infinity_norm,
                           get_diagonal)
from ..blas.level2 import gemv
from ..blas.level3 import _check_mcmr
from .lu import lu
from .cholesky import cholesky
from .ldl import ldl, inertia as _ldl_inertia
from .funcs import inverse


def _perm_sign(perm) -> float:
    """Parity of a permutation vector (host-side cycle count)."""
    p = perm.detach().cpu().numpy() if torch.is_tensor(perm) \
        else np.asarray(perm)
    n = p.shape[0]
    seen = np.zeros(n, bool)
    sign = 1.0
    for i in range(n):
        if seen[i]:
            continue
        j = i
        clen = 0
        while not seen[j]:
            seen[j] = True
            j = int(p[j])
            clen += 1
        if clen % 2 == 0:
            sign = -sign
    return sign


def _square(A: DistMatrix, what: str) -> int:
    _check_mcmr(A)
    n = A.gshape[0]
    if A.gshape != (n, n):
        raise ValueError(f"{what} needs square, got {A.gshape}")
    return n


def determinant(A: DistMatrix, nb: int | None = None, precision=None):
    """det(A) via LU with partial pivoting (``El::Determinant``)."""
    n = _square(A, "determinant")
    if n == 0:
        return torch.ones((), dtype=A.dtype, device=A.local.device)
    LU_, perm = lu(A, nb=nb, precision=precision)
    diag = get_diagonal(LU_).local[:, 0]
    return torch.prod(diag) * _perm_sign(perm)


def safe_determinant(A: DistMatrix, nb: int | None = None, precision=None):
    """(rho, kappa, n) with det = rho * exp(kappa * n): unit-modulus rho and
    a log-scaled magnitude (``El::SafeDeterminant``, overflow-proof)."""
    n = _square(A, "safe_determinant")
    dev = A.local.device
    if n == 0:
        return (torch.ones((), dtype=A.dtype, device=dev),
                torch.zeros((), device=dev), 0)
    LU_, perm = lu(A, nb=nb, precision=precision)
    diag = get_diagonal(LU_).local[:, 0]
    mags = diag.abs()
    safe = torch.where(mags == 0, 1.0, mags)
    rho = torch.prod(torch.where(mags == 0, 0.0, diag / safe)) \
        * _perm_sign(perm)
    kappa = torch.sum(torch.log(safe)) / n
    kappa = torch.where(torch.any(mags == 0), -math.inf, kappa)
    return rho, kappa, n


def hpd_determinant(A: DistMatrix, uplo: str = "L", nb: int | None = None,
                    precision=None):
    """det of an HPD matrix via Cholesky: prod(diag(L))^2
    (``El::HPDDeterminant``)."""
    L = cholesky(A, uplo, nb=nb, precision=precision)
    diag = get_diagonal(L).local[:, 0].real
    return torch.prod(diag) ** 2


def two_norm_estimate(A: DistMatrix, iters: int = 20, seed: int = 0,
                      precision=None):
    """Power-iteration estimate of ||A||_2 (``El::TwoNormEstimate``).  The
    start vector comes from ``np.random.default_rng(seed)``, as in the
    JAX package, so both start from the same x."""
    _check_mcmr(A)
    m, n = A.gshape
    rng = np.random.default_rng(seed)
    npdt = np.dtype(str(A.dtype).replace("torch.", ""))
    if A.dtype.is_complex:
        x0 = (rng.normal(size=(n, 1)) + 1j * rng.normal(size=(n, 1)))
    else:
        x0 = rng.normal(size=(n, 1))
    x = from_global(x0.astype(npdt), MC, MR, grid=A.grid)
    nx0 = frobenius_norm(x)
    x = x.with_local(x.local / torch.clamp_min(nx0, 1e-300))
    est = torch.zeros((), dtype=A.local.real.dtype, device=A.local.device)
    for _ in range(iters):
        # one step of power iteration on A^H A: est -> sigma_max^2
        y = gemv(A, x, precision=precision)
        z = gemv(A, y, orient="C", precision=precision)
        est = frobenius_norm(z)
        x = z.with_local(z.local / torch.clamp_min(est, 1e-300))
    return torch.sqrt(est)


def _singular_values(A: DistMatrix, nb, precision):
    from .spectral import svd
    return svd(A, vectors=False, nb=nb, precision=precision)


def condition(A: DistMatrix, p: str = "two", nb: int | None = None,
              precision=None):
    """Condition number in the given norm (``El::Condition``)."""
    _check_mcmr(A)
    p = p.lower()
    if p in ("two", "2"):
        s = _singular_values(A, nb, precision)
        smin = s[-1]
        return torch.where(smin > 0, s[0] / torch.where(smin == 0, 1, smin),
                           math.inf)
    Ai = inverse(A, nb=nb, precision=precision)
    if p in ("one", "1"):
        return one_norm(A) * one_norm(Ai)
    if p in ("inf", "infinity"):
        return infinity_norm(A) * infinity_norm(Ai)
    if p in ("frob", "frobenius"):
        return frobenius_norm(A) * frobenius_norm(Ai)
    raise ValueError(f"unknown norm {p!r}")


def inertia(A: DistMatrix, uplo: str = "L", nb: int | None = None,
            precision=None):
    """(n+, n-, n0) eigenvalue-sign counts of a Hermitian matrix via pivoted
    LDL + Sylvester's law (``El::Inertia``)."""
    _, d, e, _ = ldl(A, uplo, nb=nb, precision=precision)
    return _ldl_inertia(d, e)


def nuclear_norm(A: DistMatrix, nb: int | None = None, precision=None):
    """Sum of singular values (``El::NuclearNorm``)."""
    return torch.sum(_singular_values(A, nb, precision))


def schatten_norm(A: DistMatrix, p: float, nb: int | None = None,
                  precision=None):
    """(sum s_i^p)^(1/p) (``El::SchattenNorm``)."""
    s = _singular_values(A, nb, precision)
    return torch.sum(s ** p) ** (1.0 / p)


def two_norm(A: DistMatrix, nb: int | None = None, precision=None):
    """Largest singular value (``El::TwoNorm``)."""
    return _singular_values(A, nb, precision)[0]
