"""Optimization models reduced to the LP/QP solvers + prox ADMM.

PyTorch port of ``elemental_tpu/optimization/models.py`` (Elemental
``src/optimization/models/**`` -- ``BP.cpp`` (basis pursuit -> LP),
``LAV.cpp`` (least absolute value regression -> LP), ``NNLS.cpp`` (->
QP), ``Lasso``/BPDN (-> QP), ``SVM.cpp`` (soft-margin -> QP), ``RPCA.cpp``
(ADMM with SVT), and the breadth models CP, DS, EN, NMF, SparseInvCov,
LongOnlyPortfolio, TV).

Each model assembles its standard form with the distributed stacking
primitives (vstack/hstack/interior_update) and hands off to
:func:`..optimization.lp.lp` / :func:`..optimization.qp.qp` or the
affine solvers.  The models that build their data on the host
(:func:`cp`, :func:`ds`, :func:`en`, :func:`nmf`,
:func:`long_only_portfolio`, :func:`tv`) take the dtype of their input
(the JAX package builds float64 under x64), and :func:`tv`'s
``grid=None`` is :func:`~..core.grid.default_grid` (the card).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.distmatrix import DistMatrix, from_global, to_global, _numpy_dtype
from ..redist.interior import interior_view, interior_update, vstack, hstack, _blank
from ..core.dist import MC, MR
from ..blas.level1 import shift_diagonal, frobenius_norm
from ..blas.level3 import gemm
from .lp import lp, _tp
from .qp import qp
from .prox import soft_threshold, svt
from .util import MehrotraCtrl


def _identity_like(A: DistMatrix, m: int) -> DistMatrix:
    return shift_diagonal(_blank(m, m, A), 1)


def _neg(A: DistMatrix) -> DistMatrix:
    return A.with_local(-A.local)


def _ones(A: DistMatrix, m: int) -> DistMatrix:
    from ..blas.level1 import fill
    return fill(_blank(m, 1, A), 1)


def bp(A: DistMatrix, b: DistMatrix, ctrl: MehrotraCtrl | None = None,
       nb: int | None = None, precision=None):
    """Basis pursuit min ||x||_1 s.t. Ax = b (``El::BP``): split x = u - v,
    LP over [u; v] >= 0."""
    m, n = A.gshape
    Ae = hstack(A, _neg(A))
    ce = _ones(A, 2 * n)
    x2, _, _, info = lp(Ae, b, ce, ctrl, nb=nb, precision=precision)
    u = interior_view(x2, (0, n), (0, 1))
    v = interior_view(x2, (n, 2 * n), (0, 1))
    return u.with_local(u.local - v.local), info


def lav(A: DistMatrix, b: DistMatrix, ctrl: MehrotraCtrl | None = None,
        nb: int | None = None, precision=None):
    """Least-absolute-value regression min ||Ax - b||_1 (``El::LAV``):
    x = xp - xm, residual r = u - v, LP over [xp; xm; u; v] >= 0."""
    m, n = A.gshape
    I = _identity_like(A, m)
    Ae = hstack(hstack(A, _neg(A)), hstack(I, _neg(I)))
    cz = _blank(2 * n, 1, A)
    co = _ones(A, 2 * m)
    ce = vstack(cz, co)
    x4, _, _, info = lp(Ae, b, ce, ctrl, nb=nb, precision=precision)
    xp = interior_view(x4, (0, n), (0, 1))
    xm = interior_view(x4, (n, 2 * n), (0, 1))
    return xp.with_local(xp.local - xm.local), info


def nnls(A: DistMatrix, b: DistMatrix, ctrl: MehrotraCtrl | None = None,
         nb: int | None = None, precision=None):
    """Nonnegative least squares min ||Ax - b||_2, x >= 0 (``El::NNLS``):
    QP with Q = A^T A, c = -A^T b."""
    At = _tp(A)
    Q = gemm(At, A, nb=nb, precision=precision)
    c = _neg(gemm(At, b, nb=nb, precision=precision))
    x, _, _, info = qp(Q, c, ctrl=ctrl, nb=nb, precision=precision)
    return x, info


def lasso(A: DistMatrix, b: DistMatrix, lam: float,
          ctrl: MehrotraCtrl | None = None, nb: int | None = None,
          precision=None):
    """min 1/2 ||Ax - b||^2 + lam ||x||_1 (``El::Lasso``/BPDN): split
    x = u - v, QP over [u; v] >= 0 with Q = [[G, -G], [-G, G]]."""
    m, n = A.gshape
    At = _tp(A)
    G = gemm(At, A, nb=nb, precision=precision)
    Atb = gemm(At, b, nb=nb, precision=precision)
    Q = _blank(2 * n, 2 * n, A)
    Q = interior_update(Q, G, (0, 0))
    Q = interior_update(Q, _neg(G), (0, n))
    Q = interior_update(Q, _neg(G), (n, 0))
    Q = interior_update(Q, G, (n, n))
    lam1 = _ones(A, 2 * n)
    c = vstack(_neg(Atb), Atb)
    c = c.with_local(lam * lam1.local + c.local)
    x2, _, _, info = qp(Q, c, ctrl=ctrl, nb=nb, precision=precision)
    u = interior_view(x2, (0, n), (0, 1))
    v = interior_view(x2, (n, 2 * n), (0, 1))
    return u.with_local(u.local - v.local), info


def svm(X: DistMatrix, labels, C: float = 1.0,
        ctrl: MehrotraCtrl | None = None, nb: int | None = None,
        precision=None):
    """Soft-margin linear SVM (``El::SVM``) via the box-constrained dual

        min 1/2 a^T (Y X X^T Y) a - 1^T a,  0 <= a <= C,  y^T a = 0

    solved as a standard-form QP over [a; s] with a + s = C.  Returns
    (w, bias, info)."""
    m, n = X.gshape
    y = torch.as_tensor(np.asarray(labels),
                        device=X.local.device).reshape(-1)
    if y.shape[0] != m:
        raise ValueError(f"labels must have length {m}")
    Xt = _tp(X)
    K = gemm(X, Xt, nb=nb, precision=precision)          # m x m Gram
    # Y K Y scaling is a rank-structured elementwise op: do it via the
    # replicated label vector on storage index maps
    from ..blas.level1 import _global_indices
    I, J = _global_indices(K)
    yI = y[I.clamp(0, m - 1)][:, None]
    yJ = y[J.clamp(0, m - 1)][None, :]
    Kyy = K.with_local(K.local * yI * yJ)
    Q = _blank(2 * m, 2 * m, X)
    Q = interior_update(Q, Kyy, (0, 0))
    c = vstack(_neg(_ones(X, m)), _blank(m, 1, X))
    # equality constraints: y^T a = 0;  a + s = C
    yrow = from_global(np.asarray(labels, np.float64).reshape(1, -1)
                       .astype(_numpy_dtype(X.dtype)), MC, MR, grid=X.grid)
    Arow = hstack(yrow, _blank(1, m, X))
    I_m = _identity_like(X, m)
    Abox = hstack(I_m, I_m)
    Ae = vstack(Arow, Abox)
    be = vstack(_blank(1, 1, X), _ones(X, m).with_local(
        C * _ones(X, m).local))
    x2, _, _, info = qp(Q, c, Ae, be, ctrl=ctrl, nb=nb, precision=precision)
    a = interior_view(x2, (0, m), (0, 1))
    # w = X^T (a . y);  bias from margin support vectors (0 < a < C)
    ay = a.with_local(a.local
                      * y[_global_indices(a)[0].clamp(0, m - 1)][:, None])
    w = gemm(Xt, ay, nb=nb, precision=precision)
    ag = _tg(a).ravel()
    Xg = _tg(X)
    wg = _tg(w).ravel()
    sv = (ag > 1e-6 * C) & (ag < (1 - 1e-6) * C)
    yn = y.cpu().numpy()
    bias = float(np.mean(yn[sv] - Xg[sv] @ wg)) if np.any(sv) else 0.0
    return w, bias, info


def rpca(M: DistMatrix, lam: float | None = None, tol: float = 1e-6,
         max_iters: int = 100, nb: int | None = None, precision=None):
    """Robust PCA min ||L||_* + lam ||S||_1 s.t. L + S = M (``El::RPCA``,
    ALM/ADMM with singular-value thresholding).  Returns (L, S, info)."""
    m, n = M.gshape
    lam = lam if lam is not None else 1.0 / math.sqrt(max(m, n))
    normM = float(frobenius_norm(M))
    # canonical IALM parameters (Lin-Chen-Ma): Y0 = M / J(M), mu0 = 1.25/||M||_2
    from ..lapack.spectral import svd as _svd
    s2 = float(_svd(M, vectors=False, nb=nb, precision=precision)[0])
    ninf = float(torch.max(torch.abs(M.local)))
    J = max(s2, ninf / lam, 1e-300)
    S = M.with_local(torch.zeros_like(M.local))
    Y = M.with_local(M.local / J)
    mu = 1.25 / max(s2, 1e-300)
    mu_max = mu * 1e7
    info = {"iters": 0, "converged": False}
    for it in range(max_iters):
        L = svt(M.with_local(M.local - S.local + Y.local / mu), 1.0 / mu,
                nb=nb, precision=precision)
        S = soft_threshold(M.with_local(M.local - L.local + Y.local / mu),
                           lam / mu)
        R = M.with_local(M.local - L.local - S.local)
        Y = Y.with_local(Y.local + mu * R.local)
        mu = min(1.5 * mu, mu_max)          # inexact-ALM penalty growth
        err = float(frobenius_norm(R)) / max(normM, 1e-300)
        info.update(iters=it, err=err)
        if err < tol:
            info["converged"] = True
            break
    return L, S, info


# ---------------------------------------------------------------------
# model breadth (the rest of src/optimization/models/**)
# ---------------------------------------------------------------------

def _from_np(M, grid, dtype=np.float64):
    """A host array as an [MC,MR] matrix of ``dtype`` on ``grid`` (the
    callers pass their input's dtype)."""
    M = np.atleast_2d(np.asarray(M, dtype))
    return from_global(M, MC, MR, grid=grid)


def _tg(A: DistMatrix) -> np.ndarray:
    return to_global(A).cpu().numpy()


def _npdt(A: DistMatrix):
    return _numpy_dtype(A.dtype)


def cp(A: DistMatrix, b: DistMatrix, ctrl: MehrotraCtrl | None = None,
       nb: int | None = None, precision=None):
    """Chebyshev point: min ||Ax - b||_inf (``El::CP``): affine LP on
    (x, t) with -t <= (Ax - b)_i <= t.  Returns (x, info)."""
    from .affine import lp_affine
    m, n = A.gshape
    g = A.grid
    An = _tg(A)
    bn = _tg(b).ravel()
    G = np.block([[An, -np.ones((m, 1))], [-An, -np.ones((m, 1))]])
    h = np.concatenate([bn, -bn])
    c = np.concatenate([np.zeros(n), [1.0]])
    dt = _npdt(A)
    x, y, z, s, info = lp_affine(None, _from_np(G, g, dt), None,
                                 _from_np(c.reshape(-1, 1), g, dt),
                                 _from_np(h.reshape(-1, 1), g, dt),
                                 ctrl, nb, precision)
    return x[:n], info


def ds(A: DistMatrix, b: DistMatrix, lam: float,
       ctrl: MehrotraCtrl | None = None, nb: int | None = None,
       precision=None):
    """Dantzig selector: min ||x||_1 s.t. ||A^T(b - Ax)||_inf <= lam
    (``El::DS``): affine LP on split x = u - v >= 0.  Returns (x, info)."""
    from .affine import lp_affine
    m, n = A.gshape
    g = A.grid
    An = _tg(A)
    bn = _tg(b).ravel()
    AtA = An.T @ An
    Atb = An.T @ bn
    # variables (u, v) >= 0; constraints -lam <= A'b - A'A(u - v) <= lam
    G = np.block([
        [-AtA, AtA],                      # A'A(u-v) >= A'b - lam
        [AtA, -AtA],                      # A'A(u-v) <= A'b + lam
        [-np.eye(n), np.zeros((n, n))],   # u >= 0
        [np.zeros((n, n)), -np.eye(n)],   # v >= 0
    ])
    h = np.concatenate([lam - Atb, lam + Atb, np.zeros(2 * n)])
    c = np.ones(2 * n)
    dt = _npdt(A)
    x, y, z, s, info = lp_affine(None, _from_np(G, g, dt), None,
                                 _from_np(c.reshape(-1, 1), g, dt),
                                 _from_np(h.reshape(-1, 1), g, dt),
                                 ctrl, nb, precision)
    return x[:n] - x[n:], info


def en(A: DistMatrix, b: DistMatrix, lam1: float, lam2: float,
       ctrl: MehrotraCtrl | None = None, nb: int | None = None,
       precision=None):
    """Elastic net: min (1/2)||Ax-b||^2 + lam1 ||x||_1 + (lam2/2)||x||^2
    (``El::EN``): QP on the split x = u - v >= 0.  Returns (x, info)."""
    from .affine import qp_affine
    m, n = A.gshape
    g = A.grid
    An = _tg(A)
    bn = _tg(b).ravel()
    AtA = An.T @ An
    Q = np.block([[AtA + lam2 * np.eye(n), -AtA],
                  [-AtA, AtA + lam2 * np.eye(n)]])
    c = lam1 * np.ones(2 * n) - np.concatenate([An.T @ bn, -(An.T @ bn)])
    G = -np.eye(2 * n)
    h = np.zeros(2 * n)
    dt = _npdt(A)
    x, y, z, s, info = qp_affine(_from_np(Q, g, dt), None,
                                 _from_np(G, g, dt),
                                 None, _from_np(c.reshape(-1, 1), g, dt),
                                 _from_np(h.reshape(-1, 1), g, dt),
                                 ctrl, nb, precision)
    return x[:n] - x[n:], info


def nmf(X: DistMatrix, rank: int, max_iters: int = 200, tol: float = 1e-5,
        seed: int = 0, nb: int | None = None, precision=None):
    """Nonnegative matrix factorization X ~= W H, W, H >= 0 (``El::NMF``).

    As in the JAX package, the Lee-Seung multiplicative updates run
    instead of upstream's alternating NNLS solves -- the SAME monotone
    objective descent, but each step is two distributed matmuls per
    factor rather than per-column QP solves.  W and H start from
    ``numpy.random.default_rng(seed)`` in X's dtype.
    Returns (W, H, info)."""
    m, n = X.gshape
    g = X.grid
    rng = np.random.default_rng(seed)
    W = _from_np(np.abs(rng.normal(size=(m, rank))) + 0.1, g, _npdt(X))
    H = _from_np(np.abs(rng.normal(size=(rank, n))) + 0.1, g, _npdt(X))
    eps = 1e-12
    last = np.inf
    nrmX = max(float(frobenius_norm(X)), 1e-30)
    info = {"iters": 0}
    for it in range(max_iters):
        # H <- H * (W'X) / (W'W H)
        WtX = gemm(W, X, orient_a="T", nb=nb, precision=precision)
        WtWH = gemm(gemm(W, W, orient_a="T", nb=nb, precision=precision),
                    H, nb=nb, precision=precision)
        H = H.with_local(H.local * WtX.local / (WtWH.local + eps))
        # W <- W * (X H') / (W H H')
        XHt = gemm(X, H, orient_b="T", nb=nb, precision=precision)
        WHHt = gemm(W, gemm(H, H, orient_b="T", nb=nb, precision=precision),
                    nb=nb, precision=precision)
        W = W.with_local(W.local * XHt.local / (WHHt.local + eps))
        R = gemm(W, H, nb=nb, precision=precision)
        err = float(frobenius_norm(X.with_local(X.local - R.local))) \
            / nrmX
        info.update(iters=it, rel_err=err)
        if abs(last - err) < tol * max(err, 1e-30):
            break
        last = err
    return W, H, info


def sparse_inv_cov(S: DistMatrix, lam: float, rho: float = 1.0,
                   max_iters: int = 300, tol: float = 1e-6,
                   nb: int | None = None, precision=None):
    """Graphical lasso: min tr(S X) - logdet X + lam ||X||_1
    (``El::SparseInvCov``, ADMM): the X-update is one Hermitian
    eigensolve (matmul-rich), the Z-update a soft-threshold.
    Returns (Z, info) -- Z is the SPARSE consensus iterate (the
    soft-thresholded copy); it is symmetric but not guaranteed positive
    definite, so take logdet/Cholesky of the problem's X-side quantity,
    not of this return."""
    from ..lapack.spectral import herm_eig
    from ..core.dist import STAR
    from ..core.distmatrix import DistMatrix as _DM
    n = S.gshape[0]
    g = S.grid
    Z = S.with_local(torch.zeros_like(S.local))
    U = S.with_local(torch.zeros_like(S.local))
    info = {"iters": 0, "converged": False}
    X = Z
    for it in range(max_iters):
        # X-update: minimize tr(SX) - logdet X + rho/2 ||X - Z + U||^2
        # => eig-decompose rho (Z - U) - S and shift eigenvalues
        M = S.with_local(rho * (Z.local - U.local) - S.local)
        w, V = herm_eig(M, nb=nb, precision=precision)
        xi = (w + torch.sqrt(w * w + 4.0 * rho)) / (2.0 * rho)
        d = _DM(xi.reshape(-1, 1).to(S.dtype), (n, 1), STAR, STAR,
                0, 0, g)
        from ..blas.level1 import diagonal_scale
        X = gemm(diagonal_scale("R", d, V), V, orient_b="T", nb=nb,
                 precision=precision)
        Zold = Z
        Z = soft_threshold(X.with_local(X.local + U.local), lam / rho)
        U = U.with_local(U.local + X.local - Z.local)
        prim = float(frobenius_norm(X.with_local(X.local - Z.local)))
        dual = rho * float(frobenius_norm(
            Z.with_local(Z.local - Zold.local)))
        info.update(iters=it, prim=prim, dual=dual)
        if prim < tol * n and dual < tol * n:
            info["converged"] = True
            break
    return Z, info


def long_only_portfolio(Sigma: DistMatrix, mu_vec, gamma: float = 1.0,
                        ctrl: MehrotraCtrl | None = None,
                        nb: int | None = None, precision=None):
    """Long-only risk-adjusted portfolio (``El::LongOnlyPortfolio``):
    max mu'x - gamma * sqrt(x' Sigma x)  s.t.  1'x = 1, x >= 0,
    as the SOCP min -mu'x + gamma t with ||Sigma^{1/2} x|| <= t.

    NOTE on the objective: the risk term is the STANDARD DEVIATION
    (the SOCP-natural form per SURVEY.md §3.5's "(SOCP)" row); a
    variance-penalized gamma from a QP formulation does not transfer
    at the same value.  Returns (x, info)."""
    from .affine import socp_affine
    n = Sigma.gshape[0]
    g = Sigma.grid
    Sn = _tg(Sigma)
    mu_ = np.asarray(mu_vec).ravel()
    w, V = np.linalg.eigh((Sn + Sn.T) / 2)
    Shalf = V @ np.diag(np.sqrt(np.maximum(w, 0))) @ V.T
    # variables (x, t); cones: n order-1 (x >= 0) + one order-(n+1) SOC
    G = np.zeros((n + 1 + n, n + 1))
    h = np.zeros(n + 1 + n)
    for i in range(n):                       # s_i = x_i  (order-1 cones)
        G[i, i] = -1.0
    G[n, n] = -1.0                           # SOC head: s = t
    G[n + 1:, :n] = -Shalf                   # SOC barb: Sigma^{1/2} x
    A = np.concatenate([np.ones(n), [0.0]]).reshape(1, -1)
    b = np.array([1.0])
    c = np.concatenate([-mu_, [gamma]])
    orders = [1] * n + [n + 1]
    dt = _npdt(Sigma)
    x, y, z, s, info = socp_affine(_from_np(A, g, dt), _from_np(G, g, dt),
                                   _from_np(b.reshape(-1, 1), g, dt),
                                   _from_np(c.reshape(-1, 1), g, dt),
                                   _from_np(h.reshape(-1, 1), g, dt),
                                   orders, ctrl, nb, precision)
    return x[:n], info


def tv(b, lam: float, grid=None, ctrl: MehrotraCtrl | None = None,
       nb: int | None = None, precision=None):
    """1-D total-variation denoising: min (1/2)||x-b||^2 + lam ||Dx||_1
    (``El::TV``): QP on (x, t) with -t <= Dx <= t.  ``grid=None`` is the
    default grid (the card); the data take ``b``'s floating dtype
    (float64 for an integer ``b``).  Returns (x, info)."""
    from .affine import qp_affine
    from ..core.grid import default_grid
    g = grid or default_grid()
    bn = np.asarray(b).ravel()
    dt = bn.dtype if np.issubdtype(bn.dtype, np.floating) else np.float64
    n = bn.shape[0]
    D = (np.eye(n - 1, n, 1) - np.eye(n - 1, n))
    N = n + (n - 1)
    Q = np.zeros((N, N))
    Q[:n, :n] = np.eye(n)
    c = np.concatenate([-bn, lam * np.ones(n - 1)])
    G = np.block([[D, -np.eye(n - 1)], [-D, -np.eye(n - 1)]])
    h = np.zeros(2 * (n - 1))
    x, y, z, s, info = qp_affine(_from_np(Q, g, dt), None,
                                 _from_np(G, g, dt),
                                 None, _from_np(c.reshape(-1, 1), g, dt),
                                 _from_np(h.reshape(-1, 1), g, dt),
                                 ctrl, nb, precision)
    return x[:n], info
