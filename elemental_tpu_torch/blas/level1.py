"""Level-1 zoo: elementwise ops, index maps, diagonals and reductions.

PyTorch port of ``elemental_tpu/blas/level1.py`` (Elemental
``src/blas_like/level1/*.cpp``: Axpy, Scale, Dot, Nrm2, Zero, Fill,
EntrywiseMap, Hadamard, MakeTrapezoidal, MakeSymmetric/Hermitian,
DiagonalScale, GetDiagonal/SetDiagonal, ...).

The stacked storage holds every global entry exactly once and its padding
is zero, so elementwise ops between operands of one layout and every
entrywise reduction run directly on the storage tensors.  Only
index-dependent ops (trapezoidal masks, diagonals) need the cyclic index
maps.  The diagonal ops address the k diagonal entries by their storage
coordinates (:func:`_diag_positions`, O(k) work) where the JAX package
masks the whole storage array; both move the same values.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dist import Dist
from ..core.distmatrix import DistMatrix, _global_index_dim
from ..redist.engine import redistribute, transpose_dist


def _check_same_layout(A: DistMatrix, B: DistMatrix):
    if A.dist != B.dist or (A.calign, A.ralign) != (B.calign, B.ralign) \
            or A.gshape != B.gshape or A.grid != B.grid:
        raise ValueError(f"layout mismatch: {A} vs {B}")


# ---- elementwise ----------------------------------------------------

def axpy(alpha, X: DistMatrix, Y: DistMatrix) -> DistMatrix:
    _check_same_layout(X, Y)
    return Y.with_local(alpha * X.local + Y.local)


def scale(alpha, A: DistMatrix) -> DistMatrix:
    return A.with_local(alpha * A.local)


def zero(A: DistMatrix) -> DistMatrix:
    return A.with_local(torch.zeros_like(A.local))


def fill(A: DistMatrix, value) -> DistMatrix:
    """Fill with a constant (padding kept zero via the global-index mask)."""
    v = torch.as_tensor(value, dtype=A.dtype, device=A.local.device)
    return A.with_local(torch.where(_valid_mask(A), v, 0))


def entrywise_map(A: DistMatrix, fn) -> DistMatrix:
    """EntrywiseMap; ``fn`` must map 0 -> 0 or the padding is re-zeroed."""
    return A.with_local(torch.where(_valid_mask(A), fn(A.local), 0))


def hadamard(A: DistMatrix, B: DistMatrix) -> DistMatrix:
    _check_same_layout(A, B)
    return A.with_local(A.local * B.local)


def conjugate(A: DistMatrix) -> DistMatrix:
    return A.with_local(A.local.conj_physical())


# ---- index-dependent maps -------------------------------------------

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
    return A.with_local(torch.where(_trapezoid_mask(A, uplo, offset),
                                    A.local, 0))


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


# ---- diagonals --------------------------------------------------------

def _diag_length(m: int, n: int, offset: int) -> int:
    k = min(m, n - offset) if offset >= 0 else min(m + offset, n)
    return max(k, 0)


def _diag_positions(A: DistMatrix, offset: int):
    """Storage coordinates ``(rows, cols)`` of the diagonal entries
    ``(t + max(0, -offset), t + max(0, offset))``, t = 0 .. k-1."""
    m, n = A.gshape
    k = _diag_length(m, n, offset)
    t = np.arange(k)
    gi, gj = t + max(0, -offset), t + max(0, offset)
    if A.cdist is not Dist.CIRC:
        r, c = A.grid.height, A.grid.width
        gi = _global_index_dim(m, A.cdist, r, c, A.calign, A.local_rows)[gi]
        gj = _global_index_dim(n, A.rdist, r, c, A.ralign, A.local_cols)[gj]
    dev = A.local.device
    return (torch.as_tensor(gi, dtype=torch.long, device=dev),
            torch.as_tensor(gj, dtype=torch.long, device=dev))


def shift_diagonal(A: DistMatrix, alpha, offset: int = 0) -> DistMatrix:
    """A += alpha*I on the given diagonal (ShiftDiagonal / UpdateDiagonal)."""
    ri, cj = _diag_positions(A, offset)
    out = A.local.clone()
    vals = torch.as_tensor(alpha, dtype=A.dtype, device=out.device)
    out.index_put_((ri, cj), vals.expand(ri.shape[0]), accumulate=True)
    return A.with_local(out)


def get_diagonal(A: DistMatrix, offset: int = 0, dist: str = "star"):
    """Diagonal of A as a (k, 1) DistMatrix.

    ``dist='star'`` (default): replicated [STAR,STAR].  ``dist='md'``: the
    [MD,STAR] output (the reference's return type): diagonal entry k of
    an [MC,MR] matrix lives on rank (k%r, k%c), which is its MD owner."""
    from ..core.dist import STAR
    if dist == "md":
        return _get_diagonal_md(A, offset)
    if dist != "star":
        raise ValueError(f"get_diagonal dist must be 'star' or 'md', "
                         f"got {dist!r}")
    ri, cj = _diag_positions(A, offset)
    k = ri.shape[0]
    return DistMatrix(A.local[ri, cj].reshape(k, 1), (k, 1), STAR, STAR,
                      0, 0, A.grid)


def _get_diagonal_md(A: DistMatrix, offset: int):
    """[MD,STAR] diagonal extraction (offset 0)."""
    from ..core.dist import MC, MR, MD, STAR, md_slot_of_global, stride
    from ..core import indexing as ix
    if offset != 0:
        raise NotImplementedError("MD output supports the main diagonal")
    if (A.cdist, A.rdist) != (MC, MR) or A.calign or A.ralign:
        raise ValueError("MD extraction needs a zero-aligned [MC,MR] source")
    m, n = A.gshape
    k = min(m, n)
    r, c = A.grid.height, A.grid.width
    l = ix.max_local_length(k, stride(MD, r, c))
    ri, cj = _diag_positions(A, 0)
    dev = A.local.device
    slots = torch.as_tensor(md_slot_of_global(r, c, k), dtype=torch.long,
                            device=dev)
    stor = torch.zeros((r * c * l, 1), dtype=A.dtype, device=dev)
    stor[slots, 0] = A.local[ri, cj]
    return DistMatrix(stor, (k, 1), MD, STAR, 0, 0, A.grid)


def _diag_vals(A: DistMatrix, d: DistMatrix, offset: int):
    """(storage coordinates, values) of the diagonal that the set/update
    diagonal ops write: entry t gets ``d[t]`` (clipped to d's length)."""
    ri, cj = _diag_positions(A, offset)
    dv = d.local.reshape(-1)
    t = torch.arange(ri.shape[0], device=dv.device).clamp(
        max=max(dv.shape[0] - 1, 0))
    return ri, cj, dv[t].to(A.dtype)


def set_diagonal(A: DistMatrix, d: DistMatrix, offset: int = 0) -> DistMatrix:
    """Write a replicated (k,1) diagonal into A."""
    ri, cj, vals = _diag_vals(A, d, offset)
    out = A.local.clone()
    out[ri, cj] = vals
    return A.with_local(out)


def update_diagonal(A: DistMatrix, d: DistMatrix, offset: int = 0) -> DistMatrix:
    """A += diag(d) on the given diagonal; d replicated (k,1)
    (``El::UpdateDiagonal`` with a vector)."""
    ri, cj, vals = _diag_vals(A, d, offset)
    out = A.local.clone()
    out.index_put_((ri, cj), vals, accumulate=True)
    return A.with_local(out)


def diagonal_scale(side: str, d: DistMatrix, A: DistMatrix) -> DistMatrix:
    """A := diag(d) A (side=L) or A diag(d) (side=R); d replicated (k,1)."""
    I, J = _global_indices(A)
    dv = d.local.reshape(-1)
    if side.upper().startswith("L"):
        vals = dv[I.clamp(0, dv.shape[0] - 1)]
        return A.with_local(A.local * vals[:, None])
    vals = dv[J.clamp(0, dv.shape[0] - 1)]
    return A.with_local(A.local * vals[None, :])


def diagonal_solve(side: str, d: DistMatrix, A: DistMatrix) -> DistMatrix:
    dv = d.local.reshape(-1)
    dinv = torch.where(dv != 0, 1 / torch.where(dv == 0, 1, dv), 0)
    return diagonal_scale(side, d.with_local(dinv.reshape(-1, 1)), A)


# ---- reductions (storage-based: each entry once, padding zero) -------

def frobenius_norm(A: DistMatrix):
    return torch.linalg.vector_norm(A.local)


def max_norm(A: DistMatrix):
    if A.local.numel() == 0:
        return torch.zeros((), dtype=A.local.real.dtype,
                           device=A.local.device)
    return A.local.abs().max()


def one_norm(A: DistMatrix):
    """max column sum -- column permutation of storage is irrelevant."""
    return A.local.abs().sum(dim=0).max()


def infinity_norm(A: DistMatrix):
    return A.local.abs().sum(dim=1).max()


def entrywise_norm(A: DistMatrix, p):
    return (A.local.abs() ** p).sum() ** (1.0 / p)


def zero_norm(A: DistMatrix, tol=0.0):
    return (A.local.abs() > tol).sum()


def dot(A: DistMatrix, B: DistMatrix):
    """Hilbert-Schmidt inner product <A,B> = sum conj(A) * B."""
    _check_same_layout(A, B)
    return (A.local.conj() * B.local).sum()


def nrm2(A: DistMatrix):
    return frobenius_norm(A)


def trace(A: DistMatrix):
    return get_diagonal(A).local.sum()


# ---- orientation / parts (Transpose.cpp, RealPart.cpp, Conjugate.cpp) ----

def transpose(A: DistMatrix, conj: bool = False) -> DistMatrix:
    """B = A^T (``El::Transpose``): the dist-transpose, then back to A's
    distribution pair."""
    return redistribute(transpose_dist(A, conj=conj), *A.dist,
                        calign=A.calign, ralign=A.ralign)


def adjoint(A: DistMatrix) -> DistMatrix:
    """B = A^H (``El::Adjoint``)."""
    return transpose(A, conj=True)


def real_part(A: DistMatrix) -> DistMatrix:
    """``El::RealPart`` (result is the real base dtype)."""
    return A.with_local(A.local.real.clone())


def imag_part(A: DistMatrix) -> DistMatrix:
    """``El::ImagPart`` (zeros for a real matrix)."""
    if A.local.is_complex():
        return A.with_local(A.local.imag.clone())
    return A.with_local(torch.zeros_like(A.local))


def round_entries(A: DistMatrix) -> DistMatrix:
    """``El::Round``: nearest integer (half to even), entrywise (complex:
    each part)."""
    if A.local.is_complex():
        return A.with_local(torch.complex(torch.round(A.local.real),
                                          torch.round(A.local.imag)))
    return A.with_local(torch.round(A.local))


def swap(A: DistMatrix, B: DistMatrix):
    """``El::Swap``: functionally, just the exchanged pair."""
    _check_same_layout(A, B)
    return B, A


def dotu(A: DistMatrix, B: DistMatrix):
    """Non-conjugated inner product (``El::Dotu``)."""
    _check_same_layout(A, B)
    return (A.local * B.local).sum()


# ---- extremal entries with location (MaxAbsLoc / MaxLoc family) ------

def _loc_reduce(A: DistMatrix, vals, largest: bool):
    """Shared (value, (i,j)) reduction over the storage array: one argmax
    (argmin) over the each-entry-once storage, padding masked out, the
    first maximum in storage order winning a tie."""
    I, J = _global_indices(A)
    m, n = A.gshape
    valid = (I[:, None] < m) & (J[None, :] < n)
    pad = -torch.inf if largest else torch.inf
    flat = torch.where(valid, vals, pad).reshape(-1)
    idx = flat.argmax() if largest else flat.argmin()
    li, lj = idx // vals.shape[1], idx % vals.shape[1]
    return flat[idx], (I[li], J[lj])


def max_abs_loc(A: DistMatrix):
    """(|a_ij|max, (i,j)) -- ``El::MaxAbsLoc``; the LU pivot-search kernel."""
    return _loc_reduce(A, A.local.abs(), True)


def min_abs_loc(A: DistMatrix):
    """``El::MinAbsLoc``."""
    return _loc_reduce(A, A.local.abs(), False)


def max_loc(A: DistMatrix):
    """``El::MaxLoc`` (real dtypes)."""
    return _loc_reduce(A, A.local.real, True)


def min_loc(A: DistMatrix):
    """``El::MinLoc`` (real dtypes)."""
    return _loc_reduce(A, A.local.real, False)


# ---- trapezoid updates (ScaleTrapezoid.cpp, AxpyTrapezoid.cpp) -------

def _trapezoid_mask(A: DistMatrix, uplo: str, offset: int):
    I, J = _global_indices(A)
    if uplo.upper().startswith("L"):
        return J[None, :] <= I[:, None] + offset
    return J[None, :] >= I[:, None] + offset


def scale_trapezoid(alpha, A: DistMatrix, uplo: str, offset: int = 0
                    ) -> DistMatrix:
    """Scale the lower/upper trapezoid by alpha, rest untouched
    (``El::ScaleTrapezoid``)."""
    keep = _trapezoid_mask(A, uplo, offset)
    return A.with_local(torch.where(keep, alpha * A.local, A.local))


def axpy_trapezoid(alpha, X: DistMatrix, Y: DistMatrix, uplo: str,
                   offset: int = 0) -> DistMatrix:
    """Y += alpha * trapezoid(X) (``El::AxpyTrapezoid``)."""
    _check_same_layout(X, Y)
    keep = _trapezoid_mask(X, uplo, offset)
    return Y.with_local(Y.local + torch.where(keep, alpha * X.local, 0))


def safe_scale(numerator, denominator, A: DistMatrix):
    """A := (numerator/denominator) A staged to avoid overflow/underflow
    (``El::SafeScale``; the LAPACK ``dlascl`` multiplier-staging loop)."""
    fin = torch.finfo(A.local.real.dtype)
    small, big = float(fin.tiny), 1.0 / float(fin.tiny)
    cfrom, cto = float(denominator), float(numerator)
    if cfrom == 0.0:
        raise ValueError("safe_scale: denominator must be nonzero")
    out = A
    while True:
        cfrom1 = cfrom * small
        cto1 = cto / big
        if abs(cfrom1) > abs(cto) and cto != 0.0:
            mul, cfrom = small, cfrom1
        elif abs(cto1) > abs(cfrom):
            mul, cto = big, cto1
        else:
            return out.with_local(out.local * (cto / cfrom))
        out = out.with_local(out.local * mul)


# ---- submatrix access (GetSubmatrix.cpp / SetSubmatrix.cpp) ----------

def get_submatrix(A: DistMatrix, i0: int, j0: int, m: int, n: int
                  ) -> DistMatrix:
    """Copy out A[i0:i0+m, j0:j0+n] as a zero-aligned matrix of the same
    distribution (``El::GetSubmatrix`` with contiguous ranges)."""
    from ..redist.interior import interior_view
    return interior_view(A, (i0, i0 + m), (j0, j0 + n))


def set_submatrix(A: DistMatrix, i0: int, j0: int, B: DistMatrix
                  ) -> DistMatrix:
    """Write B into A[i0:.., j0:..] (``El::SetSubmatrix``)."""
    from ..redist.interior import interior_update
    return interior_update(A, B, at=(i0, j0))
