"""Matmul-free Krylov solvers on (DistSparseMatrix, DistMultiVec).

PyTorch port of ``elemental_tpu/sparse/solvers.py`` (the iterative layer
the reference wraps around its sparse factorizations --
``reg_ldl::RegularizedSolveAfter``'s FGMRES/IR refinement loops and the
sparse branch of ``El::LeastSquares``).  The loops run on the host, as in
the JAX package, with one scalar read per reduction (``float`` of a 0-d
tensor); the SpMVs and the vector algebra run on the grid's device.
``sparse_direct_solve`` factors with scipy's ``splu`` on the host and
refines against the device SpMV.
"""
from __future__ import annotations

import numpy as np

from ..core.multivec import (DistMultiVec, mv_axpy, mv_dot, mv_nrm2,
                             mv_scale, mv_zeros)
from .core import DistSparseMatrix


def _check(A: DistSparseMatrix, b: DistMultiVec, square: bool):
    m, n = A.gshape
    if square and m != n:
        raise ValueError(f"cg needs square A, got {A.gshape}")
    if b.gshape[0] != m:
        raise ValueError(f"b has {b.gshape[0]} rows, A is {A.gshape}")


def _re(t) -> float:
    """A 0-d tensor's real part as a host float (one device read)."""
    return float(t.real) if t.is_complex() else float(t)


def cg(A: DistSparseMatrix, b: DistMultiVec, x0: DistMultiVec | None = None,
       tol: float = 1e-10, maxiter: int | None = None):
    """Conjugate gradients for SPD A x = b.

    Returns (x, info) with info = {converged, iters, relres}."""
    _check(A, b, square=True)
    n = A.gshape[1]
    maxiter = 2 * n if maxiter is None else maxiter
    x = mv_zeros(n, b.width, grid=b.grid, dtype=b.dtype) if x0 is None else x0
    r = mv_axpy(-1.0, A.spmv(x), b)               # r = b - A x
    p = r
    rs = _re(mv_dot(r, r))
    bnorm = max(float(mv_nrm2(b)), 1e-300)
    iters = 0
    while iters < maxiter and np.sqrt(rs) / bnorm >= tol:
        Ap = A.spmv(p)
        alpha = rs / _re(mv_dot(p, Ap))
        x = mv_axpy(alpha, p, x)
        r = mv_axpy(-alpha, Ap, r)
        rs_new = _re(mv_dot(r, r))
        p = mv_axpy(rs_new / rs, p, r)            # p = r + beta p
        rs = rs_new
        iters += 1
    relres = np.sqrt(rs) / bnorm
    return x, {"converged": relres < tol, "iters": iters, "relres": relres}


def cgls(A: DistSparseMatrix, b: DistMultiVec,
         tol: float = 1e-10, maxiter: int | None = None,
         damp: float = 0.0):
    """CGLS: min ||A x - b||^2 + damp^2 ||x||^2 via CG on the normal
    equations, without forming A^H A (the sparse LeastSquares/Ridge path).

    Returns (x, info)."""
    _check(A, b, square=False)
    m, n = A.gshape
    maxiter = 2 * n if maxiter is None else maxiter
    x = mv_zeros(n, b.width, grid=b.grid, dtype=b.dtype)
    r = b                                          # residual in range space
    s = A.spmv_adjoint(r)                          # normal-eq residual
    if damp:
        s = mv_axpy(-damp * damp, x, s)
    p = s
    gamma = _re(mv_dot(s, s))
    s0 = max(np.sqrt(gamma), 1e-300)
    iters = 0
    while iters < maxiter and np.sqrt(gamma) / s0 >= tol:
        q = A.spmv(p)
        denom = _re(mv_dot(q, q)) + damp * damp * _re(mv_dot(p, p))
        alpha = gamma / max(denom, 1e-300)
        x = mv_axpy(alpha, p, x)
        r = mv_axpy(-alpha, q, r)
        s = A.spmv_adjoint(r)
        if damp:
            s = mv_axpy(-damp * damp, x, s)
        gamma_new = _re(mv_dot(s, s))
        p = mv_axpy(gamma_new / gamma, p, s)
        gamma = gamma_new
        iters += 1
    relres = np.sqrt(gamma) / s0
    return x, {"converged": relres < tol, "iters": iters, "relres": relres}


def gmres(A: DistSparseMatrix, b: DistMultiVec,
          tol: float = 1e-10, maxiter: int | None = None,
          restart: int = 50):
    """Restarted GMRES(restart) for general square A x = b.

    Arnoldi basis vectors are DistMultiVecs; the (restart+1, restart)
    Hessenberg least-squares is solved on host (it is tiny) -- the
    FGMRES-shaped loop of ``reg_ldl::RegularizedSolveAfter``."""
    _check(A, b, square=True)
    n = A.gshape[1]
    maxiter = 2 * n if maxiter is None else maxiter
    if b.width != 1:
        raise ValueError("gmres expects a single right-hand side")
    x = mv_zeros(n, 1, grid=b.grid, dtype=b.dtype)
    bnorm = max(float(mv_nrm2(b)), 1e-300)
    total_it = 0
    relres = np.inf
    while total_it < maxiter:
        r = mv_axpy(-1.0, A.spmv(x), b)
        beta = float(mv_nrm2(r))
        if beta / bnorm < tol:
            return x, {"converged": True, "iters": total_it,
                       "relres": beta / bnorm}
        V = [mv_scale(1.0 / beta, r)]
        k = min(restart, maxiter - total_it)
        cplx = b.dtype.is_complex
        H = np.zeros((k + 1, k), np.complex128 if cplx else np.float64)
        j_done = 0
        for j in range(k):
            w = A.spmv(V[j])
            for i in range(j + 1):                 # modified Gram-Schmidt
                hij = complex(mv_dot(V[i], w)) if cplx else _re(
                    mv_dot(V[i], w))
                H[i, j] = hij
                w = mv_axpy(-hij, V[i], w)
            hnorm = float(mv_nrm2(w))              # real even for complex A
            H[j + 1, j] = hnorm
            j_done = j + 1
            total_it += 1
            # in-loop convergence: the Arnoldi relation gives the TRUE
            # residual norm as the tiny (j+2, j+1) host least-squares
            # residual
            e1 = np.zeros(j + 2, H.dtype); e1[0] = beta
            _, res, *_ = np.linalg.lstsq(H[: j + 2, : j + 1], e1, rcond=None)
            relres = float(np.sqrt(res[0])) / bnorm if res.size \
                else float(np.linalg.norm(
                    e1 - H[: j + 2, : j + 1] @ np.linalg.lstsq(
                        H[: j + 2, : j + 1], e1, rcond=None)[0])) / bnorm
            # lucky breakdown: the Krylov space is invariant (exact solve)
            if relres < tol or hnorm < 1e-14 * max(abs(H[j, j]), 1.0):
                break
            V.append(mv_scale(1.0 / hnorm, w))
        e1 = np.zeros(j_done + 1, H.dtype); e1[0] = beta
        y, *_ = np.linalg.lstsq(H[: j_done + 1, : j_done], e1, rcond=None)
        for i in range(j_done):
            coef = complex(y[i]) if cplx else float(np.real(y[i]))
            x = mv_axpy(coef, V[i], x)
        if relres < tol:
            break
    r = mv_axpy(-1.0, A.spmv(x), b)
    relres = float(mv_nrm2(r)) / bnorm
    return x, {"converged": relres < tol, "iters": total_it,
               "relres": relres}


def sparse_direct_solve(A: DistSparseMatrix, b: DistMultiVec,
                        refine: int = 2, tol: float = 1e-12):
    """Sequential sparse-direct solve A x = b (square A) -- the
    ``El::SparseMatrix`` + ``ldl``/``LinearSolve`` sequential sparse path:
    one host splu factorization (SuperLU) + device-side SpMV iterative
    refinement, mirroring ``reg_ldl::RegularizedSolveAfter``'s
    factor-then-refine shape.  Returns (x, info)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    from ..core.multivec import mv_from_global, mv_to_global
    from .core import sparse_to_coo
    _check(A, b, square=True)
    m, n = A.gshape
    ro, co, vo = sparse_to_coo(A)
    dt = np.complex128 if np.iscomplexobj(vo) else np.float64
    M = sp.csc_matrix((vo.astype(dt), (ro, co)), shape=(m, n))
    lu = spl.splu(M)
    bh = mv_to_global(b).cpu().numpy()
    x = mv_from_global(lu.solve(bh), grid=b.grid)
    bnorm = max(float(mv_nrm2(b)), 1e-300)
    relres = np.inf
    for _ in range(refine):
        r = mv_axpy(-1.0, A.spmv(x), b)        # device-side true residual
        relres = float(mv_nrm2(r)) / bnorm
        if relres < tol:
            break
        rh = mv_to_global(r).cpu().numpy()
        x = mv_axpy(1.0, mv_from_global(lu.solve(rh), grid=b.grid), x)
    r = mv_axpy(-1.0, A.spmv(x), b)
    relres = float(mv_nrm2(r)) / bnorm
    return x, {"relres": relres, "converged": relres < max(tol, 1e-10)}
