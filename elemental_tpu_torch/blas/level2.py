"""Level-2 BLAS: distributed matrix-vector operations.

PyTorch port of ``elemental_tpu/blas/level2.py`` (Elemental
``src/blas_like/level2/``: ``Gemv``, ``Ger``, ``Symv``/``Hemv``,
``Her2``, ``Trmv``, ``Trsv``).  A vector is an (m, 1) zero-aligned
[MC,MR] DistMatrix.  The stacked storage of a DistMatrix is an index
permutation of the global matrix, so a matvec is one storage-level
matmul between compatibly permuted operands:

  N:  y_stor[MC,STAR] = A_stor @ x_stor[MR,STAR]
  T:  y_stor[MR,STAR] = A_stor^T @ x_stor[MC,STAR]

``hemv``/``symv`` read only the stored triangle: the strictly
off-triangle product rides the transposed path.
"""
from __future__ import annotations

import torch

from ..core.dist import MC, MR, STAR
from ..core.distmatrix import DistMatrix
from ..core.environment import check_precision
from ..redist.engine import redistribute
from .level3 import _check_mcmr, _mask_triangle, _safe_astype, _nonzero, trsm


def _check_vector(x: DistMatrix, extent: int, what: str):
    if x.gshape != (extent, 1):
        raise ValueError(f"{what} must be ({extent}, 1), got {x.gshape}")


def _axpby(alpha, prod_mcmr: DistMatrix, beta, y: DistMatrix | None,
           like: DistMatrix):
    if y is None:
        return prod_mcmr.with_local(_safe_astype(alpha * prod_mcmr.local,
                                                 like.dtype))
    newloc = alpha * prod_mcmr.local
    if _nonzero(beta):
        newloc = newloc + beta * y.local
    return y.with_local(_safe_astype(newloc, y.dtype))


def _matvec_n(A_local, x: DistMatrix, m: int, grid):
    """op = N storage matvec: the [MC,STAR] (m, 1) result."""
    x_mr = redistribute(x, MR, STAR)
    return DistMatrix(A_local @ x_mr.local, (m, 1), MC, STAR, 0, 0, grid)


def _matvec_t(A_local, x: DistMatrix, n: int, grid, conj: bool):
    """op = T/C storage matvec: the [MR,STAR] (n, 1) result."""
    x_mc = redistribute(x, MC, STAR)
    a = A_local.conj() if conj else A_local
    return DistMatrix(a.mT @ x_mc.local, (n, 1), MR, STAR, 0, 0, grid)


def gemv(A: DistMatrix, x: DistMatrix, alpha=1.0, beta=0.0,
         y: DistMatrix | None = None, orient: str = "N",
         precision=None) -> DistMatrix:
    """y := alpha op(A) x + beta y (``El::Gemv``)."""
    _check_mcmr(A)
    check_precision(precision, A.local)
    m, n = A.gshape
    if orient == "N":
        _check_vector(x, n, "x")
        prod = redistribute(_matvec_n(A.local, x, m, A.grid), MC, MR)
    else:
        _check_vector(x, m, "x")
        prod = redistribute(_matvec_t(A.local, x, n, A.grid, orient == "C"),
                            MC, MR)
    return _axpby(alpha, prod, beta, y, A)


def ger(alpha, x: DistMatrix, y: DistMatrix, A: DistMatrix,
        conj: bool = True, precision=None) -> DistMatrix:
    """A := A + alpha x y^H (``El::Ger``; ``conj=False`` gives ``Geru``):
    the outer product of the [MC,STAR] column and [STAR,MR] row storage
    forms, a pure-local rank-1 update."""
    _check_mcmr(A)
    check_precision(precision, A.local)
    m, n = A.gshape
    _check_vector(x, m, "x")
    _check_vector(y, n, "y")
    x_mc = redistribute(x, MC, STAR)
    y_mr = redistribute(y, MR, STAR)
    row = y_mr.local.conj().mT if conj else y_mr.local.mT
    upd = x_mc.local @ row
    return A.with_local(_safe_astype(A.local + alpha * upd, A.dtype))


def hemv(uplo: str, A: DistMatrix, x: DistMatrix, alpha=1.0, beta=0.0,
         y: DistMatrix | None = None, conj: bool = True,
         precision=None) -> DistMatrix:
    """y := alpha A x + beta y for Hermitian A stored in the ``uplo``
    triangle (``El::Hemv``; ``conj=False`` = ``Symv``).

    A = T + S^H with T the stored (full) triangle and S the strict one:
    T x rides the N path and S^H x the transposed path, so only stored
    entries are read.  The two partial results land [MC,STAR] and
    [MR,STAR] and meet on [MC,MR]."""
    _check_mcmr(A)
    check_precision(precision, A.local)
    n = A.gshape[0]
    if A.gshape != (n, n):
        raise ValueError(f"hemv needs square A, got {A.gshape}")
    _check_vector(x, n, "x")
    T = A.local.where(_mask_triangle(A, uplo), 0)
    S = A.local.where(_mask_triangle(A, uplo, strict=True), 0)
    p1 = redistribute(_matvec_n(T, x, n, A.grid), MC, MR)
    p2 = redistribute(_matvec_t(S, x, n, A.grid, conj), MC, MR)
    prod = p1.with_local(p1.local + p2.local)
    return _axpby(alpha, prod, beta, y, A)


def symv(uplo: str, A: DistMatrix, x: DistMatrix, alpha=1.0, beta=0.0,
         y: DistMatrix | None = None, precision=None) -> DistMatrix:
    return hemv(uplo, A, x, alpha, beta, y, conj=False, precision=precision)


def her2(uplo: str, alpha, x: DistMatrix, y: DistMatrix, A: DistMatrix,
         conj: bool = True, precision=None) -> DistMatrix:
    """A(tri) += alpha x y^H + conj(alpha) y x^H (``El::Her2``/``Syr2``)."""
    _check_mcmr(A)
    check_precision(precision, A.local)
    n = A.gshape[0]
    _check_vector(x, n, "x")
    _check_vector(y, n, "y")
    x_mc = redistribute(x, MC, STAR)
    y_mc = redistribute(y, MC, STAR)
    x_mr = redistribute(x, MR, STAR)
    y_mr = redistribute(y, MR, STAR)

    def _t(v):
        return (v.local.conj() if conj else v.local).mT

    a2 = alpha
    if conj:
        a2 = alpha.conj() if isinstance(alpha, torch.Tensor) else alpha.conjugate()
    upd = alpha * (x_mc.local @ _t(y_mr)) + a2 * (y_mc.local @ _t(x_mr))
    new = _safe_astype(A.local + upd, A.dtype)
    return A.with_local(new.where(_mask_triangle(A, uplo), A.local))


def trmv(uplo: str, orient: str, A: DistMatrix, x: DistMatrix,
         unit: bool = False, precision=None) -> DistMatrix:
    """x := op(tri(A)) x (``El::Trmv``)."""
    _check_mcmr(A)
    n = A.gshape[0]
    _check_vector(x, n, "x")
    T = A.local.where(_mask_triangle(A, uplo, strict=unit), 0)
    out = gemv(A.with_local(T), x, orient=orient, precision=precision)
    if unit:
        return out.with_local(out.local + x.local)
    return out


def trsv(uplo: str, orient: str, A: DistMatrix, b: DistMatrix,
         unit: bool = False, nb: int | None = None,
         precision=None) -> DistMatrix:
    """Solve op(tri(A)) x = b (``El::Trsv``): the blocked Trsm with one
    right-hand side."""
    _check_vector(b, A.gshape[0], "b")
    return trsm("L", uplo, orient, A, b, unit=unit, nb=nb, precision=precision)
