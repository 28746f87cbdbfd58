"""Views: contiguous global sub-matrices of a DistMatrix.

PyTorch port of ``elemental_tpu/core/view.py`` (the reference's FLAME
partitioning + ``View``/``LockedView``, Elemental
``include/El/core/FlamePart/``, ``View.hpp``).

With the element-cyclic layout, a global range [s, e) whose start is a
multiple of the distribution stride maps to the contiguous LOCAL range
[s/S, ceil(e/S)) on every rank -- so a view is a pure-local slice of the
stacked storage array.

Constraint (the "grain" rule): slice starts must be multiples of the dim's
stride; ends must be multiples or the true extent.  Blocked algorithms pick
block sizes as multiples of lcm(r, c) so this always holds.

On a device grid each of these is the same slice of every rank's tile
(:func:`~.ranks.per_rank`): the stacked storage's blocked view is, rank
by rank, a slice of the rank's own block.

``view`` may return a tensor that shares memory with ``A.local`` (the
library never writes into it); ``update_view`` returns a NEW matrix and
leaves ``A`` untouched, as the JAX package's functional update does.
``pad_matrix`` extends a matrix with zeros (the Chan and Golub-Kahan
SVD routes pad U with it) and ``shrink_matrix`` restricts one, re-zeroing
what falls outside.
"""
from __future__ import annotations

import dataclasses

import torch

from . import indexing as ix
from .distmatrix import DistMatrix
from .ranks import Tiles, per_rank


def _local_range(s: int, e: int, extent: int, S: int, align: int):
    if align != 0:
        raise ValueError("views require zero alignment")
    if s % S != 0:
        raise ValueError(f"view start {s} not a multiple of stride {S}")
    if e < s or e > extent:
        raise ValueError(f"view range [{s},{e}) out of bounds for extent {extent}")
    if e != extent and e % S != 0:
        raise ValueError(f"view end {e} not a multiple of stride {S} nor the extent")
    sl = s // S
    el = ix.max_local_length(e, S)
    return sl, el


def _blocked(stor, Sc, Sr):
    lr = stor.shape[0] // Sc
    lc = stor.shape[1] // Sr
    return stor.reshape(Sc, lr, Sr, lc), lr, lc


def view(A: DistMatrix, rows=None, cols=None) -> DistMatrix:
    """A[rows[0]:rows[1], cols[0]:cols[1]] as a DistMatrix (same dists)."""
    m, n = A.gshape
    rows = (0, m) if rows is None else rows
    cols = (0, n) if cols is None else cols
    Sc, Sr = A.col_stride, A.row_stride
    rsl, rel = _local_range(rows[0], rows[1], m, Sc, A.calign)
    csl, cel = _local_range(cols[0], cols[1], n, Sr, A.ralign)
    if isinstance(A.local, Tiles):
        sub = per_rank(lambda rk, x: x[rsl:rel, csl:cel], A.local)
    else:
        b, lr, lc = _blocked(A.local, Sc, Sr)
        sub = b[:, rsl:rel, :, csl:cel].reshape(Sc * (rel - rsl),
                                                Sr * (cel - csl))
    gshape = (min(rows[1], m) - rows[0], min(cols[1], n) - cols[0])
    return dataclasses.replace(A, local=sub, gshape=gshape)


def update_view(A: DistMatrix, B: DistMatrix, rows=None, cols=None) -> DistMatrix:
    """Write sub-matrix B into a copy of A at the given global ranges."""
    m, n = A.gshape
    rows = (0, m) if rows is None else rows
    cols = (0, n) if cols is None else cols
    Sc, Sr = A.col_stride, A.row_stride
    rsl, rel = _local_range(rows[0], rows[1], m, Sc, A.calign)
    csl, cel = _local_range(cols[0], cols[1], n, Sr, A.ralign)
    if isinstance(A.local, Tiles):
        def write(rk, x, y):
            out = x.clone(memory_format=torch.contiguous_format)
            out[rsl:rel, csl:cel] = y
            return out
        return A.with_local(per_rank(write, A.local, B.local))
    out = A.local.clone(memory_format=torch.contiguous_format)
    b, lr, lc = _blocked(out, Sc, Sr)
    b[:, rsl:rel, :, csl:cel] = B.local.reshape(Sc, rel - rsl, Sr, cel - csl)
    return A.with_local(out)


def round_up(x: int, grain: int) -> int:
    return -(-x // grain) * grain


def split_point(n: int, grain: int) -> int:
    """A near-halving split that respects the grain rule."""
    half = round_up(n // 2, grain)
    if half == 0 or half >= n:
        half = grain
    return min(half, n)


def pad_matrix(A: DistMatrix, M: int, N: int) -> DistMatrix:
    """Extend the global shape to (M, N) >= gshape with explicit zeros.

    A pure-local storage extension (the cyclic layout keeps each rank's
    block contiguous per residue class), as in the JAX package."""
    m, n = A.gshape
    if M < m or N < n:
        raise ValueError(f"pad_matrix target ({M},{N}) smaller than {A.gshape}")
    Sc, Sr = A.col_stride, A.row_stride
    lr2 = ix.max_local_length(M, Sc)
    lc2 = ix.max_local_length(N, Sr)
    if isinstance(A.local, Tiles):
        loc = per_rank(lambda rk, x: torch.nn.functional.pad(
            x, (0, lc2 - x.shape[1], 0, lr2 - x.shape[0])), A.local)
        return dataclasses.replace(A, local=loc, gshape=(M, N))
    b, lr, lc = _blocked(A.local, Sc, Sr)
    b = torch.nn.functional.pad(b, (0, lc2 - lc, 0, 0, 0, lr2 - lr))
    return dataclasses.replace(A, local=b.reshape(Sc * lr2, Sr * lc2),
                               gshape=(M, N))


def shrink_matrix(A: DistMatrix, m: int, n: int) -> DistMatrix:
    """Restrict the global shape to (m, n) <= gshape, re-zeroing the newly
    out-of-range entries (keeps the padding-is-zero invariant)."""
    if isinstance(A.local, Tiles):
        from .ranks import refuse
        refuse("shrink_matrix")
    M, N = A.gshape
    if m > M or n > N:
        raise ValueError(f"shrink_matrix target ({m},{n}) larger than {A.gshape}")
    Sc, Sr = A.col_stride, A.row_stride
    lr2 = ix.max_local_length(m, Sc)
    lc2 = ix.max_local_length(n, Sr)
    b, lr, lc = _blocked(A.local, Sc, Sr)
    b = b[:, :lr2, :, :lc2].reshape(Sc * lr2, Sr * lc2)
    # zero entries whose global index is now out of range
    dev = b.device
    q = torch.arange(Sc, device=dev)[:, None]
    il = torch.arange(lr2, device=dev)[None, :]
    I = (il * Sc + (q - A.calign) % Sc).reshape(-1)
    q2 = torch.arange(Sr, device=dev)[:, None]
    jl = torch.arange(lc2, device=dev)[None, :]
    J = (jl * Sr + (q2 - A.ralign) % Sr).reshape(-1)
    keep = (I[:, None] < m) & (J[None, :] < n)
    return dataclasses.replace(A, local=torch.where(keep, b, 0),
                               gshape=(m, n))
