"""Interior (arbitrary-offset) submatrix extraction and embedding.

PyTorch port of ``interior_view`` and ``interior_update`` (with
``_check_zero_aligned``) from ``elemental_tpu/redist/interior.py``,
correct-first: a block is gathered out of the stacked storage as a
global sub-matrix and laid out again, ``B = from_global(A[rs:re,
cs:ce])``, and written back through the global matrix, which moves
values and does no arithmetic, so the storage is bit-equal to the JAX
package's (whose one rotation per distributed dimension is a
collective).  On a 1x1 grid the storage IS the global matrix and each
is one slice.  On a device grid (:mod:`..core.ranks`) ``interior_view``
runs the JAX ``_extract_dim`` rank by rank: one ``ppermute`` rotation per
distributed dimension whose offset is not a stride multiple, then a
slice of each rank's block (with no motion at all at offset 0); its tiles
are the JAX shards, bit for bit.  ``interior_update`` does not run there
yet.  The stacking helpers ``_blank``, ``vstack`` and
``hstack`` (QDWH's [sqrt(c) X; I]) are one concatenation on a 1x1 grid.
"""
from __future__ import annotations

import torch

from ..core import indexing as ix
from ..core.dist import Dist, MC, MR, VC, VR, rank_of, stride as dist_stride
from ..core.distmatrix import (DistMatrix, _global_index_dim, from_global,
                               to_global)
from ..core.ranks import Tiles, per_rank, ppermute, refuse
from .device_route import _pad_dim


def _rot_perm(d: Dist, delta: int, r: int, c: int):
    """(axes, perm) rotating rank space by ``delta``: rank q receives from
    rank (q + delta) % S, as ``ppermute`` pairs over the mesh's linear
    order (mc major), VC's column-major rank translated to it."""
    if d is MC:
        return "mc", [((q + delta) % r, q) for q in range(r)]
    if d is MR:
        return "mr", [((q + delta) % c, q) for q in range(c)]
    p = r * c
    if d is VC:
        lin = [(v % r) * c + v // r for v in range(p)]
    elif d is VR:
        lin = list(range(p))
    else:
        raise ValueError(f"no permute axes for {d}")
    return ("mc", "mr"), [(lin[(q + delta) % p], lin[q]) for q in range(p)]


def _extract_tiles(xs: Tiles, dim: int, d: Dist, s: int, e: int, g) -> Tiles:
    """One dimension of the device grid's extract: global [s, e) of every
    rank's ``dim`` -> a new zero-aligned dimension (the JAX
    ``_extract_dim``)."""
    r, c = g.height, g.width
    S = dist_stride(d, r, c)
    if S == 1:
        return per_rank(lambda rk, x: x.narrow(dim, s, e - s), xs)
    l_new = ix.max_local_length(e - s, S)
    if s % S:
        xs = ppermute(xs, *_rot_perm(d, s % S, r, c))

    def cut(rk, x):
        q = rank_of(d, r, c, *rk)
        y = _pad_dim(x, dim, s // S + 1 + l_new).narrow(dim, (q + s) // S,
                                                        l_new)
        gi = torch.arange(l_new, device=x.device) * S + q
        shape = [1] * y.dim()
        shape[dim] = l_new
        return torch.where((gi < e - s).reshape(shape), y, 0)
    return per_rank(cut, xs)


def _interior_view_tiles(A: DistMatrix, rs, re, cs, ce) -> DistMatrix:
    if Dist.MD in A.dist or Dist.CIRC in A.dist:
        refuse("interior_view of an MD or CIRC matrix")
    g = A.grid
    x = _extract_tiles(A.local, 0, A.cdist, rs, re, g)
    x = _extract_tiles(x, 1, A.rdist, cs, ce, g)
    if A.col_stride == A.row_stride == 1:
        # two slices: a view of A's tiles until copied
        x = per_rank(lambda rk, t: t.clone(), x)
    return DistMatrix(x, (re - rs, ce - cs), A.cdist, A.rdist, 0, 0, g)


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
    if isinstance(A.local, Tiles):
        return _interior_view_tiles(A, rs, re, cs, ce)
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
    if isinstance(A.local, Tiles):
        refuse("interior_update")
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
