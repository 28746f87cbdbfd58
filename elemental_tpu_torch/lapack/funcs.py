"""Matrix functions: QDWH polar, matrix sign, inverses, pseudoinverse,
square roots, and the polar-based spectral divide-and-conquer eigensolver.

PyTorch port of ``elemental_tpu/lapack/funcs.py`` (Elemental
``src/lapack_like/funcs/``: ``Sign.cpp``, ``Polar`` (``polar::QDWH``),
``Inverse/**``, ``TriangularInverse``, ``HPDInverse``,
``Pseudoinverse.cpp``, ``SquareRoot.cpp``).

Every QDWH step is a Cholesky or a QR plus a few large products: the
Cholesky step runs ``herk``, ``cholesky`` (the ``potrf_inv`` kernel on
the card) and two right-side ``trsm``; the QR step factors the stacked
[sqrt(c) X; I] with ``qr`` (the ``qr_panel`` kernel), forms the thin Q
with ``apply_q`` and multiplies its two blocks.  The (a, b, c) schedule
does not depend on the data, so it is computed on the host.
:func:`_qdwh_eig` splits the spectrum recursively with polar projectors
and extracts the deflated blocks with :mod:`..redist.interior`.

The host reads what the JAX package reads: ``polar`` one norm product,
``_dc_eig`` the median, the norm and ``trace(P)`` once a node, ``sign``
and ``square_root`` their norms once an iteration.  The port's calls of
``gemm`` name ``alg='dot'`` (on 1x1 one full-precision matmul), where
the JAX package lets the tuner pick.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dist import MC, MR, STAR
from ..core.distmatrix import DistMatrix, from_global
from ..redist.engine import redistribute, transpose_dist
from ..redist.interior import interior_view, interior_update, vstack, _blank
from ..blas.level1 import (frobenius_norm, one_norm, infinity_norm,
                           shift_diagonal, get_diagonal, make_symmetric,
                           diagonal_scale, trace as dm_trace)
from ..blas.level3 import _check_mcmr, gemm, trsm, herk
from .cholesky import cholesky, hpd_solve
from .lu import lu_solve, permute_cols
from .qr import qr, apply_q


def _real_dtype(dtype):
    return torch.empty((), dtype=dtype).real.dtype


def _eps_of(dtype) -> float:
    return float(torch.finfo(_real_dtype(dtype)).eps)


def _identity_like(A: DistMatrix, m: int, n: int | None = None) -> DistMatrix:
    out = _blank(m, n or m, A)
    return shift_diagonal(out, 1)


def _hermitianize(H: DistMatrix) -> DistMatrix:
    Ht = redistribute(transpose_dist(H, conj=True), MC, MR)
    return H.with_local(0.5 * (H.local + Ht.local))


# ---------------------------------------------------------------------
# QDWH polar decomposition
# ---------------------------------------------------------------------

def _qdwh_schedule(l0: float, tol: float, maxiter: int = 32):
    """Host-side (a, b, c) parameter schedule from the lower bound l0.

    The dynamically-weighted Halley parameters (Nakatsukasa-Bai-Gygi /
    Nakatsukasa-Higham); l_{k+1} = l_k (a + b l^2) / (1 + c l^2) does not
    depend on the data, so the whole schedule is static."""
    params = []
    l = float(l0)
    while 1.0 - l > tol and len(params) < maxiter:
        l2 = l * l
        dd = (4.0 * (1.0 - l2) / (l2 * l2)) ** (1.0 / 3.0)
        sqd = math.sqrt(1.0 + dd)
        a = sqd + 0.5 * math.sqrt(
            max(8.0 - 4.0 * dd + 8.0 * (2.0 - l2) / (l2 * sqd), 0.0))
        b = (a - 1.0) ** 2 / 4.0
        c = a + b - 1.0
        params.append((a, b, c))
        l = l * (a + b * l2) / (1.0 + c * l2)
    # two pure-Halley cleanup steps (cubic convergence at the fixed point)
    params.append((3.0, 1.0, 3.0))
    params.append((3.0, 1.0, 3.0))
    return params


def _qdwh_step_chol(X: DistMatrix, a, b, c, nb, precision) -> DistMatrix:
    """Cholesky-variant step (safe once c is moderate): Z = I + c X^H X,
    Z = W W^H, X' = (b/c) X + (a - b/c) X W^{-H} W^{-1}."""
    Z = herk("L", X, alpha=c, orient="C", nb=nb, precision=precision)
    Z = shift_diagonal(Z, 1)
    W = cholesky(Z, "L", nb=nb, precision=precision)
    del Z
    B = trsm("R", "L", "C", W, X, nb=nb, precision=precision)   # X W^{-H}
    B = trsm("R", "L", "N", W, B, nb=nb, precision=precision)   # ... W^{-1}
    out = B.local.mul_(a - b / c).add_(X.local, alpha=b / c)
    return X.with_local(out)


def _qdwh_step_qr(X: DistMatrix, a, b, c, nb, precision) -> DistMatrix:
    """QR-variant step (numerically safe for huge c):
    [sqrt(c) X; I] = Q R, X' = (b/c) X + (a - b/c)/sqrt(c) Q1 Q2^H.
    S, the identity E and the thin Q are dropped as soon as each is
    spent (at n = 16384 float32 each holds 2 GB)."""
    m, n = X.gshape
    sc = math.sqrt(c)
    S = vstack(X.with_local(sc * X.local), _identity_like(X, n, n))
    Ap, tau = qr(S, nb=nb, precision=precision)
    del S
    # thin Q = Q [I; 0], with the blocking qr recorded on Ap
    E = _identity_like(X, m + n, n)
    Qthin = apply_q(Ap, tau, E, orient="N", precision=precision)
    del E, Ap, tau
    Q1 = interior_view(Qthin, (0, m), (0, n))
    Q2 = interior_view(Qthin, (m, m + n), (0, n))
    del Qthin
    G = gemm(Q1, Q2, orient_b="C", alg="dot", nb=nb, precision=precision)
    del Q1, Q2
    out = G.local.mul_((a - b / c) / sc).add_(X.local, alpha=b / c)
    return X.with_local(out)


def polar(A: DistMatrix, nb: int | None = None, precision=None,
          l_min: float | None = None, qr_c_switch: float = 100.0):
    """Polar decomposition ``A = U H`` with U a partial isometry (m >= n:
    U^H U = I) and H Hermitian PSD (Elemental ``El::Polar``, QDWH variant).

    ``l_min``: lower bound on sigma_min(A)/sigma_max(A) (defaults to ~eps of
    the dtype -- an underestimate only adds iterations)."""
    _check_mcmr(A)
    m, n = A.gshape
    if m < n:
        # A^H = W K  =>  A = (W^H)(W K W^H)
        W, K = polar(redistribute(transpose_dist(A, conj=True), MC, MR),
                     nb=nb, precision=precision, l_min=l_min)
        U = redistribute(transpose_dist(W, conj=True), MC, MR)
        H = gemm(gemm(W, K, alg="dot", nb=nb, precision=precision), W,
                 orient_b="C", alg="dot", nb=nb, precision=precision)
        return U, _hermitianize(H)

    tiny = torch.finfo(_real_dtype(A.dtype)).tiny
    alpha = float(torch.sqrt(torch.clamp(one_norm(A) * infinity_norm(A),
                                         min=tiny)))
    if not np.isfinite(alpha) or alpha == 0.0:
        return _identity_like(A, m, n), A.with_local(torch.zeros_like(A.local))
    X = A.with_local((A.local / alpha).to(A.dtype))
    eps = _eps_of(A.dtype)
    l0 = l_min if l_min is not None else eps
    for (a, b, c) in _qdwh_schedule(l0, tol=10 * eps):
        if c > qr_c_switch:
            X = _qdwh_step_qr(X, a, b, c, nb, precision)
        else:
            X = _qdwh_step_chol(X, a, b, c, nb, precision)
    U = X
    H = gemm(U, A, orient_a="C", alg="dot", nb=nb, precision=precision)
    return U, _hermitianize(H)


# ---------------------------------------------------------------------
# Matrix sign (Newton with norm scaling)
# ---------------------------------------------------------------------

def sign(A: DistMatrix, nb: int | None = None, precision=None,
         maxiter: int = 40, tol: float | None = None) -> DistMatrix:
    """Matrix sign function via scaled Newton iteration
    ``X <- (mu X + (mu X)^{-1}) / 2`` (``El::Sign``).  A must have no
    purely imaginary eigenvalue.  The host reads three norms an
    iteration, as the JAX package does."""
    _check_mcmr(A)
    n = A.gshape[0]
    if A.gshape != (n, n):
        raise ValueError(f"sign needs square, got {A.gshape}")
    eps = _eps_of(A.dtype)
    tol = tol if tol is not None else n * 10 * eps
    X = A
    I = _identity_like(A, n)
    for it in range(maxiter):
        Xi = lu_solve(X, I, nb=nb, precision=precision)
        nx = float(frobenius_norm(X))
        ni = float(frobenius_norm(Xi))
        if not np.isfinite(nx) or not np.isfinite(ni):
            raise FloatingPointError("sign iteration diverged (singular A?)")
        mu = math.sqrt(ni / nx) if it < maxiter - 1 else 1.0
        Xnew = X.with_local(0.5 * (mu * X.local + (1.0 / mu) * Xi.local))
        delta = float(frobenius_norm(X.with_local(Xnew.local - X.local)))
        X = Xnew
        if delta <= tol * max(float(frobenius_norm(X)), 1e-30):
            break
    return X


# ---------------------------------------------------------------------
# Inverse family
# ---------------------------------------------------------------------

def inverse(A: DistMatrix, nb: int | None = None, precision=None) -> DistMatrix:
    """A^{-1} via LU with partial pivoting (``El::Inverse``)."""
    _check_mcmr(A)
    n = A.gshape[0]
    if A.gshape != (n, n):
        raise ValueError(f"inverse needs square, got {A.gshape}")
    return lu_solve(A, _identity_like(A, n), nb=nb, precision=precision)


def triangular_inverse(uplo: str, A: DistMatrix, unit: bool = False,
                       nb: int | None = None, precision=None) -> DistMatrix:
    """inv(tri(A)) (``El::TriangularInverse``)."""
    _check_mcmr(A)
    n = A.gshape[0]
    return trsm("L", uplo, "N", A, _identity_like(A, n), unit=unit,
                nb=nb, precision=precision)


def hpd_inverse(A: DistMatrix, uplo: str = "L", nb: int | None = None,
                precision=None) -> DistMatrix:
    """Inverse of an HPD matrix via Cholesky (``El::HPDInverse``)."""
    _check_mcmr(A)
    n = A.gshape[0]
    return hpd_solve(A, _identity_like(A, n), uplo, nb=nb,
                     precision=precision)


def pseudoinverse(A: DistMatrix, tol: float | None = None,
                  nb: int | None = None, precision=None) -> DistMatrix:
    """Moore-Penrose pseudoinverse via the SVD (``El::Pseudoinverse``):
    columns with s_i <= tol (default max(m,n) eps s_max) are dropped."""
    from .spectral import svd
    m, n = A.gshape
    U, s, V = svd(A, vectors=True, nb=nb, precision=precision)
    smax = float(s[0]) if s.shape[0] else 0.0
    cut = tol if tol is not None else max(m, n) * _eps_of(A.dtype) * smax
    sinv = torch.where(s > cut, 1.0 / torch.where(s > cut, s, 1.0), 0.0)
    d = DistMatrix(sinv[:, None].to(A.dtype), (s.shape[0], 1), STAR, STAR,
                   0, 0, A.grid)
    Vs = diagonal_scale("R", d, V)
    return gemm(Vs, U, orient_b="C", alg="dot", nb=nb, precision=precision)


# ---------------------------------------------------------------------
# Square roots
# ---------------------------------------------------------------------

def square_root(A: DistMatrix, nb: int | None = None, precision=None,
                maxiter: int = 30, tol: float | None = None) -> DistMatrix:
    """Principal square root via the Denman-Beavers iteration
    (``El::SquareRoot`` uses the same Newton family):
    ``Y <- (Y + Z^{-1})/2, Z <- (Z + Y^{-1})/2``; Y -> A^{1/2}.
    A must have no eigenvalue on the closed negative real axis."""
    _check_mcmr(A)
    n = A.gshape[0]
    if A.gshape != (n, n):
        raise ValueError(f"square_root needs square, got {A.gshape}")
    eps = _eps_of(A.dtype)
    tol = tol if tol is not None else n * 10 * eps
    I = _identity_like(A, n)
    Y, Z = A, I
    for _ in range(maxiter):
        Yi = lu_solve(Y, I, nb=nb, precision=precision)
        Zi = lu_solve(Z, I, nb=nb, precision=precision)
        Ynew = Y.with_local(0.5 * (Y.local + Zi.local))
        Z = Z.with_local(0.5 * (Z.local + Yi.local))
        delta = float(frobenius_norm(Y.with_local(Ynew.local - Y.local)))
        Y = Ynew
        if delta <= tol * max(float(frobenius_norm(Y)), 1e-30):
            break
    return Y


def hpd_square_root(A: DistMatrix, uplo: str = "L", nb: int | None = None,
                    precision=None) -> DistMatrix:
    """A^{1/2} of an HPD matrix via its eigendecomposition
    (``El::HPSDSquareRoot`` analog): Z diag(sqrt(w)) Z^H."""
    from .spectral import herm_eig
    w, Z = herm_eig(A, uplo, vectors=True, nb=nb, precision=precision)
    sw = torch.sqrt(torch.clamp(w, min=0)).to(A.dtype)
    d = DistMatrix(sw[:, None], (w.shape[0], 1), STAR, STAR, 0, 0, A.grid)
    Zs = diagonal_scale("R", d, Z)
    return gemm(Zs, Z, orient_b="C", alg="dot", nb=nb, precision=precision)


# ---------------------------------------------------------------------
# QDWH-eig: polar-based spectral divide and conquer
# ---------------------------------------------------------------------

def _replicated_eig(A: DistMatrix, vectors: bool):
    """Base case: gather the (small) block and solve redundantly."""
    n = A.gshape[0]
    Ag = redistribute(A, STAR, STAR).local
    w, Z = torch.linalg.eigh(Ag)
    w = w.to(_real_dtype(A.dtype))
    if not vectors:
        return w, None
    Zd = redistribute(
        DistMatrix(Z.to(A.dtype), (n, n), STAR, STAR, 0, 0, A.grid), MC, MR)
    return w, Zd


def _median(d) -> float:
    """numpy's median: the mean of the two middle values at even length."""
    s = torch.sort(d).values
    n = s.shape[0]
    return float((s[(n - 1) // 2] + s[n // 2]) / 2)


def _dc_eig(A: DistMatrix, vectors: bool, nb, precision, base: int,
            seed: int, depth: int = 0):
    """Recursive QDWH-eig on a FULL (both triangles stored) Hermitian
    [MC,MR] matrix.  Returns (w ascending replicated, Z or None)."""
    n = A.gshape[0]
    g = A.grid
    if n <= max(base, 2) or depth > 60:
        return _replicated_eig(A, vectors)
    d = get_diagonal(A).local[:, 0].real
    sigma = _median(d)
    scale = max(float(frobenius_norm(A)), 1e-30)
    for attempt in range(3):
        As = shift_diagonal(A, -sigma)
        # U = sign(A - sigma I) via QDWH polar (Hermitian => polar == sign)
        U, _H = polar(As, nb=nb, precision=precision)
        del _H
        # projector onto the eigenspace below sigma: P = (I - U)/2
        P = shift_diagonal(U.with_local(-0.5 * U.local), 0.5)
        del U
        k = int(round(float(dm_trace(P).real)))
        if 0 < k < n:
            break
        # split failed: all eigenvalues on one side of sigma.  If the block
        # is (numerically) a multiple of the identity, deflate outright.
        rms = float(frobenius_norm(As)) / math.sqrt(n)
        if rms <= 10 * n * _eps_of(A.dtype) * scale:
            w = torch.full((n,), sigma, dtype=_real_dtype(A.dtype),
                           device=A.local.device)
            return (w, _identity_like(A, n) if vectors else None)
        sigma = sigma + rms if k == 0 else sigma - rms
    else:
        # no splitting shift found (pathological clustering): fall back
        return _replicated_eig(A, vectors)
    del As

    # orthonormal basis of range(P) via a randomized range-finder + QR;
    # the explicit numpy generator draws the JAX package's G
    rng = np.random.default_rng(0xE1E0 + 31 * seed + depth)
    G = rng.normal(size=(n, k)).astype(np.float64)
    rnp = {torch.float32: np.float32, torch.float64: np.float64}[
        _real_dtype(A.dtype)]
    Gd = from_global(torch.from_numpy(G.astype(rnp)), MC, MR, grid=g)
    Gd = Gd.with_local(Gd.local.to(A.dtype))
    Y = gemm(P, Gd, alg="dot", nb=nb, precision=precision)
    del P, Gd
    Qp, tau = qr(Y, nb=nb, precision=precision)
    del Y
    # C = Q^H A Q  (two packed-reflector applications + a transposition)
    T1 = apply_q(Qp, tau, A, orient="C", nb=nb, precision=precision)
    T2 = redistribute(transpose_dist(T1, conj=True), MC, MR)
    del T1
    T3 = apply_q(Qp, tau, T2, orient="C", nb=nb, precision=precision)
    del T2
    C = redistribute(transpose_dist(T3, conj=True), MC, MR)
    del T3
    A1 = _hermitianize(interior_view(C, (0, k), (0, k)))
    A2 = _hermitianize(interior_view(C, (k, n), (k, n)))
    del C
    w1, Z1 = _dc_eig(A1, vectors, nb, precision, base, 2 * seed + 1,
                     depth + 1)
    del A1
    w2, Z2 = _dc_eig(A2, vectors, nb, precision, base, 2 * seed + 2,
                     depth + 1)
    del A2
    w = torch.cat([w1, w2])
    if not vectors:
        return w, None
    BD = _blank(n, n, A)
    BD = interior_update(BD, Z1, (0, 0))
    BD = interior_update(BD, Z2, (k, k))
    del Z1, Z2
    Z = apply_q(Qp, tau, BD, orient="N", nb=nb, precision=precision)
    return w, Z


def _qdwh_eig(A: DistMatrix, uplo: str = "L", vectors: bool = True,
              subset=None, nb: int | None = None, precision=None,
              base: int | None = None):
    """Spectral divide-and-conquer eigensolver (QDWH-eig): splits ride
    :mod:`..redist.interior`, the base case gathers only ``base x base``
    blocks."""
    from .spectral import _subset_slice
    _check_mcmr(A)
    n = A.gshape[0]
    if A.gshape != (n, n):
        raise ValueError(f"_qdwh_eig needs square, got {A.gshape}")
    full = make_symmetric(A, uplo, conj=True)
    base = base if base is not None else 128
    w, Z = _dc_eig(full, vectors, nb, precision, base, seed=1)
    # guard the seams: blocks are spectrum-ordered by construction, but
    # boundary rounding can micro-misorder; sort if needed
    order = torch.argsort(w, stable=True)
    w = w[order]
    s, e = _subset_slice(w, subset)
    if not vectors:
        return w[s:e]
    Z = permute_cols(Z, order)
    if (s, e) != (0, n):
        Z = interior_view(Z, (0, n), (s, e))
    return w[s:e], Z
