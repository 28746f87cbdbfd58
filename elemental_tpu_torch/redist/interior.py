"""Interior (arbitrary-offset) submatrix extraction and embedding.

PyTorch port of ``interior_view`` and ``interior_update`` (with
``_check_zero_aligned``) from ``elemental_tpu/redist/interior.py``,
correct-first: a block is gathered out of the stacked storage as a
global sub-matrix and laid out again, ``B = from_global(A[rs:re,
cs:ce])``, and written back through the global matrix, which moves
values and does no arithmetic, so the storage is bit-equal to the JAX
package's (whose one rotation per distributed dimension is a
collective).  On a 1x1 grid the storage IS the global matrix and each
is one slice.  The stacking helpers ``_blank``, ``vstack`` and
``hstack`` (QDWH's [sqrt(c) X; I]) are one concatenation on a 1x1 grid.
"""
from __future__ import annotations

import torch

from ..core.dist import Dist
from ..core.distmatrix import (DistMatrix, _global_index_dim, from_global,
                               to_global)


def _check_zero_aligned(*Ms: DistMatrix):
    for A in Ms:
        if (A.calign, A.ralign) != (0, 0):
            raise ValueError(f"interior ops require zero alignment, got {A}")


def interior_view(A: DistMatrix, rows=None, cols=None) -> DistMatrix:
    """``A[rows[0]:rows[1], cols[0]:cols[1]]`` as a new zero-aligned
    DistMatrix (same distribution pair), for ARBITRARY offsets."""
    _check_zero_aligned(A)
    m, n = A.gshape
    rows = (0, m) if rows is None else rows
    cols = (0, n) if cols is None else cols
    (rs, re), (cs, ce) = rows, cols
    if not (0 <= rs <= re <= m and 0 <= cs <= ce <= n):
        raise ValueError(f"range ({rows},{cols}) out of bounds for {A.gshape}")
    g = A.grid
    if g.size == 1 or A.cdist is Dist.CIRC:
        return DistMatrix(A.local[rs:re, cs:ce].clone(), (re - rs, ce - cs),
                          A.cdist, A.rdist, 0, 0, g)
    r, c = g.height, g.width
    dev = A.local.device
    ri = _global_index_dim(m, A.cdist, r, c, 0, A.local_rows)[rs:re]
    cj = _global_index_dim(n, A.rdist, r, c, 0, A.local_cols)[cs:ce]
    block = A.local.index_select(0, torch.as_tensor(ri, device=dev))
    block = block.index_select(1, torch.as_tensor(cj, device=dev))
    return from_global(block, A.cdist, A.rdist, g)


def interior_update(A: DistMatrix, B: DistMatrix, at=(0, 0)) -> DistMatrix:
    """Functionally write ``B`` into ``A`` starting at global ``at=(i0,j0)``
    (arbitrary offsets; B must share A's distribution pair and grid).
    Returns a new matrix; ``A`` is left untouched."""
    _check_zero_aligned(A, B)
    if B.dist != A.dist or B.grid != A.grid:
        raise ValueError(f"interior_update needs matching layout: {A} vs {B}")
    i0, j0 = at
    m, n = A.gshape
    h, w = B.gshape
    if i0 + h > m or j0 + w > n:
        raise ValueError(f"block {B.gshape} at {at} exceeds {A.gshape}")
    g = A.grid
    if g.size == 1 or A.cdist is Dist.CIRC:
        out = A.local.clone()
        out[i0:i0 + h, j0:j0 + w] = B.local
        return A.with_local(out)
    G = to_global(A)
    G[i0:i0 + h, j0:j0 + w] = to_global(B)
    return from_global(G, A.cdist, A.rdist, g)


# ---------------------------------------------------------------------
# stacking helpers (QDWH's [sqrt(c) X; I] and friends)
# ---------------------------------------------------------------------

def _blank(m: int, n: int, like: DistMatrix) -> DistMatrix:
    """A zero (m, n) matrix with ``like``'s distribution pair, grid and
    dtype."""
    meta = DistMatrix(None, (m, n), like.cdist, like.rdist, 0, 0, like.grid)
    stor = torch.zeros((meta.col_stride * meta.local_rows,
                        meta.row_stride * meta.local_cols),
                       dtype=like.dtype, device=like.local.device)
    return meta.with_local(stor)


def vstack(A: DistMatrix, B: DistMatrix) -> DistMatrix:
    """[A; B] (concatenate rows) with A's distribution pair."""
    if A.gshape[1] != B.gshape[1]:
        raise ValueError(f"vstack width mismatch {A.gshape} vs {B.gshape}")
    if A.grid.size == 1 and A.dist == B.dist:
        return DistMatrix(torch.cat([A.local, B.local.to(A.dtype)]),
                          (A.gshape[0] + B.gshape[0], A.gshape[1]),
                          A.cdist, A.rdist, 0, 0, A.grid)
    out = _blank(A.gshape[0] + B.gshape[0], A.gshape[1], A)
    out = interior_update(out, A, (0, 0))
    return interior_update(out, B, (A.gshape[0], 0))


def hstack(A: DistMatrix, B: DistMatrix) -> DistMatrix:
    """[A, B] (concatenate columns) with A's distribution pair."""
    if A.gshape[0] != B.gshape[0]:
        raise ValueError(f"hstack height mismatch {A.gshape} vs {B.gshape}")
    if A.grid.size == 1 and A.dist == B.dist:
        return DistMatrix(torch.cat([A.local, B.local.to(A.dtype)], dim=1),
                          (A.gshape[0], A.gshape[1] + B.gshape[1]),
                          A.cdist, A.rdist, 0, 0, A.grid)
    out = _blank(A.gshape[0], A.gshape[1] + B.gshape[1], A)
    out = interior_update(out, A, (0, 0))
    return interior_update(out, B, (0, A.gshape[1]))
