"""Euclidean minimization breadth: Ridge, Tikhonov, GLM, LSE.

PyTorch port of ``elemental_tpu/lapack/euclidean_min.py`` (Elemental
``src/lapack_like/euclidean_min/``: ``Ridge.cpp``, ``Tikhonov.cpp``,
``GLM.cpp``, the general Gauss-Markov linear model, and ``LSE.cpp``,
equality-constrained least squares).  The dense ``least_squares`` driver
lives in :mod:`.qr`.

Ridge and Tikhonov solve the stacked least-squares problem (one
``vstack`` and the QR path, safer than the normal equations); LSE solves
the symmetric-indefinite KKT system with the Bunch-Kaufman ``ldl``; GLM
uses the covariance form with Cholesky solves (B of full row rank).  The
JAX package lets the tuner pick each ``gemm`` schedule; the port names
``alg='dot'``, on 1x1 one matmul.
"""
from __future__ import annotations

from ..core.dist import MC, MR
from ..core.distmatrix import DistMatrix
from ..redist.engine import redistribute, transpose_dist
from ..redist.interior import interior_view, interior_update, vstack, _blank
from ..blas.level1 import shift_diagonal
from ..blas.level3 import _check_mcmr, gemm
from .qr import least_squares
from .cholesky import cholesky, cholesky_solve_after
from .ldl import ldl, ldl_solve_after


def ridge(A: DistMatrix, b: DistMatrix, gamma: float,
          nb: int | None = None, precision=None) -> DistMatrix:
    """min ||A x - b||^2 + gamma^2 ||x||^2 (``El::Ridge``): the stacked
    least-squares problem [A; gamma I] x = [b; 0]."""
    _check_mcmr(A, b)
    m, n = A.gshape
    gI = shift_diagonal(_blank(n, n, A), gamma)
    As = vstack(A, gI)
    bs = vstack(b, _blank(n, b.gshape[1], b))
    return least_squares(As, bs, nb=nb, precision=precision)


def tikhonov(A: DistMatrix, b: DistMatrix, G: DistMatrix,
             nb: int | None = None, precision=None) -> DistMatrix:
    """min ||A x - b||^2 + ||G x||^2 (``El::Tikhonov``): stacked
    least squares [A; G] x = [b; 0]."""
    _check_mcmr(A, b, G)
    As = vstack(A, G)
    bs = vstack(b, _blank(G.gshape[0], b.gshape[1], b))
    return least_squares(As, bs, nb=nb, precision=precision)


def lse(A: DistMatrix, b: DistMatrix, C: DistMatrix, d: DistMatrix,
        nb: int | None = None, precision=None):
    """Equality-constrained least squares min ||A x - b|| s.t. C x = d
    (``El::LSE``): the symmetric-indefinite KKT system

        [ A^H A   C^H ] [ x      ]   [ A^H b ]
        [   C      0  ] [ lambda ] = [   d   ]

    solved with the pivoted LDL.  Returns x."""
    _check_mcmr(A, b, C, d)
    m, n = A.gshape
    p = C.gshape[0]
    K = _blank(n + p, n + p, A)
    K = interior_update(K, gemm(A, A, orient_a="C", alg="dot", nb=nb,
                                precision=precision), (0, 0))
    K = interior_update(K, _tp_conj(C), (0, n))
    K = interior_update(K, C, (n, 0))
    rhs = vstack(gemm(A, b, orient_a="C", alg="dot", nb=nb,
                      precision=precision), d)
    conj = A.dtype.is_complex
    Lp, dk, ek, perm = ldl(K, conjugate=conj, nb=nb, precision=precision)
    sol = ldl_solve_after(Lp, dk, ek, perm, rhs, conjugate=conj, nb=nb,
                          precision=precision)
    return interior_view(sol, (0, n), (0, b.gshape[1]))


def glm(A: DistMatrix, B: DistMatrix, d: DistMatrix,
        nb: int | None = None, precision=None):
    """General (Gauss-Markov) linear model (``El::GLM``):

        min ||y||  s.t.  d = A x + B y

    via the covariance form with W = B B^H HPD (B full row rank):
    solve (A^H W^{-1} A) x = A^H W^{-1} d, then y = B^H W^{-1} (d - A x).
    Returns (x, y)."""
    _check_mcmr(A, B, d)
    Bt = _tp_conj(B)
    W = gemm(B, B, orient_b="C", alg="dot", nb=nb, precision=precision)
    Lw = cholesky(W, "L", nb=nb, precision=precision)
    Wid = cholesky_solve_after(Lw, d, nb=nb, precision=precision)
    WiA = cholesky_solve_after(Lw, A, nb=nb, precision=precision)
    Ah = _tp_conj(A)
    M = gemm(Ah, WiA, alg="dot", nb=nb, precision=precision)
    rhs = gemm(Ah, Wid, alg="dot", nb=nb, precision=precision)
    # M = A^H W^{-1} A is HPD for full-column-rank A
    Lm = cholesky(M, "L", nb=nb, precision=precision)
    x = cholesky_solve_after(Lm, rhs, nb=nb, precision=precision)
    resid = d.with_local(d.local - gemm(A, x, alg="dot", nb=nb,
                                        precision=precision).local)
    y = gemm(Bt, cholesky_solve_after(Lw, resid, nb=nb, precision=precision),
             alg="dot", nb=nb, precision=precision)
    return x, y


def _tp_conj(A):
    return redistribute(transpose_dist(A, conj=True), MC, MR)
