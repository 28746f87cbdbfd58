"""Level-1 helpers: index maps, trapezoids and the symmetric fill.

PyTorch port of ``_global_indices``, ``_valid_mask``,
``index_dependent_map``, ``index_dependent_fill``, ``make_trapezoidal``
and ``make_symmetric`` from ``elemental_tpu/blas/level1.py``.
"""
from __future__ import annotations

import torch

from ..core.distmatrix import DistMatrix
from ..redist.engine import redistribute, transpose_dist


def _global_indices(A: DistMatrix):
    """(I, J) global index tensors matching the storage array layout
    (padding positions map to indices >= the extent)."""
    Sc, Sr = A.col_stride, A.row_stride
    lr, lc = A.local_rows, A.local_cols
    dev = A.local.device
    q = torch.arange(Sc, device=dev)[:, None]
    il = torch.arange(lr, device=dev)[None, :]
    I = (il * Sc + (q - A.calign) % Sc).reshape(-1)      # storage row -> global row
    q2 = torch.arange(Sr, device=dev)[:, None]
    jl = torch.arange(lc, device=dev)[None, :]
    J = (jl * Sr + (q2 - A.ralign) % Sr).reshape(-1)
    return I, J


def _valid_mask(A: DistMatrix):
    I, J = _global_indices(A)
    m, n = A.gshape
    return (I[:, None] < m) & (J[None, :] < n)


def index_dependent_map(A: DistMatrix, fn) -> DistMatrix:
    """IndexDependentMap: B[i,j] = fn(i, j, A[i,j]) (fn broadcast over index
    tensors); padding re-zeroed."""
    I, J = _global_indices(A)
    out = fn(I[:, None], J[None, :], A.local)
    return A.with_local(torch.where(_valid_mask(A), out, 0))


def index_dependent_fill(A: DistMatrix, fn) -> DistMatrix:
    """IndexDependentFill: B[i,j] = fn(i, j)."""
    return index_dependent_map(
        A, lambda i, j, a: fn(i, j) + torch.zeros_like(a))


def make_trapezoidal(A: DistMatrix, uplo: str, offset: int = 0) -> DistMatrix:
    """Zero outside the lower/upper trapezoid (MakeTrapezoidal)."""
    I, J = _global_indices(A)
    if uplo.upper().startswith("L"):
        keep = J[None, :] <= I[:, None] + offset
    else:
        keep = J[None, :] >= I[:, None] + offset
    return A.with_local(torch.where(keep, A.local, 0))


def make_symmetric(A: DistMatrix, uplo: str = "L", conj: bool = False) -> DistMatrix:
    """Reflect the given triangle onto the other (MakeSymmetric/Hermitian):
    trapezoid(A) + trapezoid(A)^T - diag, through the transpose-dist and
    a redistribution back."""
    tri = make_trapezoidal(A, uplo, 0)
    triT = redistribute(transpose_dist(tri, conj=conj), *A.dist,
                        calign=A.calign, ralign=A.ralign)
    I, J = _global_indices(A)
    on_diag = J[None, :] == I[:, None]
    dvals = torch.where(on_diag, tri.local, 0)
    if conj and dvals.is_complex():
        dvals = dvals.real.to(A.dtype)
    return A.with_local(tri.local + triT.local - dvals)
