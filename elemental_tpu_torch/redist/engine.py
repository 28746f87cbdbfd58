"""The redistribution engine, correct-first.

PyTorch port of the entry points of ``elemental_tpu/redist/engine.py``
(the reference's ``El::copy`` namespace, Elemental
``src/blas_like/level1/Copy/*.hpp``).  The grid is virtual -- every rank's
block lives in one stacked-storage tensor on one device -- and stacked
storage is a pure index permutation of the global matrix.  So every pair
goes through the global matrix,

    B = from_global(to_global(A), cdist, rdist, calign, ralign),

which moves values and does no arithmetic: the result is bit-identical to
the JAX engine's storage.  On a 1x1 grid every distribution's storage IS
the global matrix, so there a redistribution only retags.  The batched
row moves of LU (``move_rows``, ``permute_rows_storage``) are index maps
on the stacked storage, bit-equal to the JAX engine's.  The factored
collective chains, ``redist_counts``/``redist_trace``, wire quantization
and the one-shot plans belong to later slices.
"""
from __future__ import annotations

import torch

from ..core.dist import Dist, MC, MR, VC, STAR
from ..core.distmatrix import DistMatrix, _check_pair, from_global, to_global


def apply_fault(target: str, outputs: tuple) -> tuple:
    """The ``'compute'`` fault seam of the JAX engine: identity (fault
    injection is not ported)."""
    return tuple(outputs)


def _check_wire(comm_precision, path) -> None:
    if comm_precision is not None:
        raise NotImplementedError(
            f"comm_precision={comm_precision!r}: wire quantization is not "
            "ported yet (a later slice); pass None")
    if path is not None:
        raise NotImplementedError(
            f"redist_path={path!r}: the chain/direct routes are not ported "
            "yet (a later slice); pass None")


def redistribute(A: DistMatrix, cdist: Dist, rdist: Dist,
                 calign: int = 0, ralign: int = 0,
                 comm_precision=None, path=None) -> DistMatrix:
    """``B[cdist,rdist] = A`` (``Copy(A, B)`` of the reference)."""
    _check_pair(cdist, rdist)
    _check_wire(comm_precision, path)
    if A.dist == (cdist, rdist) and (A.calign, A.ralign) == (calign, ralign):
        return A
    if A.grid.size == 1:
        # every layout's storage is the global matrix on a 1x1 grid
        return DistMatrix(A.local, A.gshape, cdist, rdist,
                          0 if cdist is Dist.CIRC else calign,
                          0 if cdist is Dist.CIRC else ralign, A.grid)
    return from_global(to_global(A), cdist, rdist, A.grid, calign, ralign)


def to_star_star(A: DistMatrix) -> DistMatrix:
    return redistribute(A, STAR, STAR)


def _from_star_star(xg, gshape, cdist, rdist, calign, ralign, grid) -> DistMatrix:
    if tuple(xg.shape) != tuple(gshape):
        raise ValueError(f"[STAR,STAR] array {tuple(xg.shape)} != {gshape}")
    return from_global(xg, cdist, rdist, grid, calign, ralign)


def transpose_dist(A: DistMatrix, conj: bool = False) -> DistMatrix:
    """A^T tagged [rdist, cdist] -- Elemental's ``copy::TransposeDist``
    (a local transpose of the storage, materialized)."""
    loc = A.local.mT.contiguous()
    if conj:
        loc = loc.conj_physical()
    m, n = A.gshape
    return DistMatrix(loc, (n, m), A.rdist, A.cdist, A.ralign, A.calign, A.grid)


def panel_spread(A: DistMatrix, conj: bool = True, comm_precision=None):
    """``(A -> [MC,STAR],  op(A)^T -> [STAR,MR])`` for a zero-aligned
    [VC,STAR] panel: the operand pair of the Hermitian rank-k update
    (``conj=True`` gives the adjoint ``A^H``, ``False`` the transpose)."""
    if A.dist != (VC, STAR) or (A.calign, A.ralign) != (0, 0):
        raise ValueError(f"panel_spread needs a zero-aligned [VC,STAR] "
                         f"panel, got {A}")
    _check_wire(comm_precision, None)
    mc = redistribute(A, MC, STAR)
    mr = redistribute(transpose_dist(A, conj=conj), STAR, MR)
    return mc, mr


# ---------------------------------------------------------------------
# batched storage-level row permutations
# ---------------------------------------------------------------------

def _storage_row_of(i, S: int, lr: int):
    """Storage row of global row i for a stride-S zero-aligned column dim
    (stacked-storage layout: slot-major, then local offset)."""
    if S == 1:
        return i
    return (i % S) * lr + i // S


def _index(x, device):
    return torch.as_tensor(x, device=device).to(torch.int64)


def move_rows(A: DistMatrix, targets, sources, valid) -> DistMatrix:
    """Move global rows ``sources`` to positions ``targets`` in one
    storage-level gather/scatter, dropping entries where ``valid`` is
    False (sentinel padding), as the JAX engine's ``mode="drop"`` scatter
    does.  Invalid entries scatter into one spare storage row that is
    sliced off, so nothing syncs with the host."""
    dev = A.local.device
    targets, sources = _index(targets, dev), _index(sources, dev)
    valid = torch.as_tensor(valid, device=dev)
    S, lr = A.col_stride, A.local_rows
    m = A.gshape[0]
    stor = A.local
    sidx = _storage_row_of(targets.clamp(0, m - 1), S, lr)
    sidx = torch.where(valid, sidx, stor.shape[0])     # the spare row
    rows = stor.index_select(0, _storage_row_of(sources.clamp(0, m - 1), S, lr))
    out = torch.cat((stor, stor.new_zeros((1, stor.shape[1]))))
    out.index_copy_(0, sidx, rows)
    return A.with_local(out[:-1])


def permute_rows_storage(A: DistMatrix, perm, inverse: bool = False
                         ) -> DistMatrix:
    """``B[i] = A[perm[i]]`` as one storage-level gather for a zero-aligned
    row-cyclic matrix (the full-permutation sibling of :func:`move_rows`);
    padding rows stay zero."""
    if (A.calign, A.ralign) != (0, 0):
        raise ValueError(f"permute_rows_storage needs zero alignments, got {A}")
    dev = A.local.device
    perm = _index(perm, dev)
    p = torch.argsort(perm) if inverse else perm
    m = A.gshape[0]
    S, lr = A.col_stride, A.local_rows
    if S == 1:
        return A.with_local(A.local.index_select(0, p))
    sr = torch.arange(S * lr, device=dev)
    gi = (sr % lr) * S + sr // lr               # global row of storage slot
    src = _storage_row_of(p[gi.clamp(0, m - 1)], S, lr)
    out = A.local.index_select(0, src)
    return A.with_local(torch.where((gi < m)[:, None], out, 0))
