"""The redistribution engine's collective route, for a device grid.

On a device grid (:mod:`..core.ranks`) every rank holds its own local
block, so a redistribution runs the JAX engine's own per-device code
(``elemental_tpu/redist/engine.py``: the primitives ``_gather_dim``,
``_filter_dim``, ``_partial_gather_dim``, ``_partial_filter_dim``, the
fused M <-> V all-to-alls, ``_realign``, ``to_star_star`` /
``_from_star_star`` and the ``to_dist`` dispatch with its single-dimension
hops and chains, ``_panel_spread_to_pair``), with its ``lax`` collectives
carried out by :func:`~..core.ranks.all_gather`,
:func:`~..core.ranks.all_to_all` and :func:`~..core.ranks.ppermute`.  A
rank's ``rank_of`` is a plain integer here, where the JAX code reads a
traced axis index.  The steps move values and do no arithmetic, so every
tile is bit-equal to the JAX shard on the same mesh device and to the
virtual grid's storage block.

:func:`..redist.engine.redistribute` and :func:`..redist.engine.
panel_spread` call in here for a device grid and record exactly what they
record for a virtual grid of the same shape.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import indexing as ix
from ..core.dist import (Dist, MC, MR, VC, VR, STAR, MD, CIRC,
                         stride as dist_stride, md_slot_of_global,
                         gather_axes, rank_of)
from ..core.distmatrix import DistMatrix, _check_pair, _take_fill
from ..core.ranks import (Tiles, all_gather, all_to_all, broadcast,
                          per_rank, ppermute, rank_map)


def _pad_dim(x, dim: int, target: int):
    """Zero-pad ``x`` along ``dim`` to ``target`` (never shrinks)."""
    cur = x.shape[dim]
    if cur >= target:
        return x
    shape = list(x.shape)
    shape[dim] = target - cur
    return torch.cat((x, x.new_zeros(shape)), dim)


def _merge(x, dim: int):
    """Merge dims ``dim`` and ``dim + 1`` of ``x`` (row-major)."""
    shape = list(x.shape)
    shape[dim:dim + 2] = [shape[dim] * shape[dim + 1]]
    return x.reshape(shape)


def _split(x, dim: int, outer: int, inner: int):
    """Split dim ``dim`` of ``x`` into (outer, inner) (row-major)."""
    shape = list(x.shape)
    shape[dim:dim + 1] = [outer, inner]
    return x.reshape(shape)


def _arange(n: int, like):
    return torch.arange(n, device=like.device)


# ---------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------

def _gather_dim(xs: Tiles, dim: int, d: Dist, align: int, extent: int,
                g) -> Tiles:
    """Rebuild the full (true-extent) dimension on every rank."""
    r, c = g.height, g.width
    if d is MD:
        if r * c == 1:
            return per_rank(lambda rk, x: x.narrow(dim, 0, extent), xs)
        # p slot ranges gathered mc-major, then the static slot
        # permutation rebuilds global order
        idx = md_slot_of_global(r, c, extent)

        def md_order(rk, gx):
            flat = _merge(gx.movedim(0, dim), dim)
            return flat.index_select(dim, torch.as_tensor(idx,
                                                          device=flat.device))
        return per_rank(md_order, all_gather(xs, ("mc", "mr")))
    S = dist_stride(d, r, c)
    if S == 1:
        return per_rank(lambda rk, x: x.narrow(dim, 0, extent), xs)

    def interleave(rk, gx):
        if align:
            gx = torch.roll(gx, -align, 0)          # block s <- shift s
        gx = _merge(gx.movedim(0, dim + 1), dim)    # index i = iLoc*S + s
        return gx.narrow(dim, 0, extent)
    return per_rank(interleave, all_gather(xs, gather_axes(d)))


def _filter_md(x, dim: int, extent: int, r: int, c: int, rk):
    """Replicated dim -> the rank's MD slot range (all zero for a rank
    outside the diagonal comm)."""
    L = dist_stride(MD, r, c)
    ll = ix.max_local_length(extent, L)
    k0 = rank_of(MD, r, c, *rk)
    gi = np.arange(ll) * L + k0
    gi = np.where((k0 < L) & (gi < extent), gi, extent)
    return _take_fill(x, dim, gi, extent)


def _filter_dim(x, dim: int, S: int, shift: int, l_out: int):
    """The rank's cyclic slice of a replicated dimension."""
    if S == 1:
        return _pad_dim(x, dim, l_out)
    x = _pad_dim(x, dim, S * l_out)
    return _split(x, dim, l_out, S).select(dim + 1, shift)


def _partial_gather_dim(xs: Tiles, dim: int, axes, nblocks: int,
                        l_out: int) -> Tiles:
    """V* -> M* ladder (``copy::PartialColAllGather``): the ranks sharing
    this dimension's coarse rank gather their fine cyclic blocks and
    interleave them."""
    if nblocks == 1:
        return per_rank(lambda rk, x: x.narrow(dim, 0, l_out), xs)
    return per_rank(
        lambda rk, gx: _merge(gx.movedim(0, dim + 1), dim).narrow(dim, 0,
                                                                  l_out),
        all_gather(xs, axes))


def _partial_filter_dim(x, dim: int, nblocks: int, sub: int, l_out: int):
    """M* -> V* ladder (``copy::PartialColFilter``): pure-local."""
    x = _pad_dim(x, dim, nblocks * l_out)
    return _split(x, dim, l_out, nblocks).select(dim + 1, sub)


# ---------------------------------------------------------------------
# fused M <-> V conversions (one all_to_all each)
# ---------------------------------------------------------------------

def _fused_to_v(A: DistMatrix) -> DistMatrix:
    """[MC,MR] -> [VC,STAR] or [MR,MC] -> [VR,STAR]: ONE all_to_all over
    the column axis refines the rows and rebuilds the full column
    extent."""
    g = A.grid
    r, c = g.height, g.width
    p = r * c
    m, n = A.gshape
    if A.dist == (MC, MR):
        ax, n_other, dst = "mr", c, VC
    else:                                   # (MR, MC)
        ax, n_other, dst = "mc", r, VR
    lt = ix.max_local_length(m, p)
    x3 = per_rank(lambda rk, x: _split(_pad_dim(x, 0, n_other * lt), 0, lt,
                                       n_other), A.local)
    y = x3 if n_other == 1 else all_to_all(x3, ax, 1, 1)

    def land(rk, y):
        z = _merge(y.movedim(1, 2), 1).narrow(1, 0, n)
        gi = _arange(lt, z) * p + rank_of(dst, r, c, *rk)
        return torch.where((gi < m)[:, None], z, 0)
    return DistMatrix(per_rank(land, y), A.gshape, dst, STAR, 0, 0, g)


def _fused_from_v(A: DistMatrix) -> DistMatrix:
    """[VC,STAR] -> [MC,MR] or [VR,STAR] -> [MR,MC] (the inverse of
    :func:`_fused_to_v`; one all_to_all over the target column axis)."""
    g = A.grid
    r, c = g.height, g.width
    m, n = A.gshape
    if A.cdist is VC:
        ax, n_other, dst, S_row = "mr", c, (MC, MR), r
    else:                                   # VR
        ax, n_other, dst, S_row = "mc", r, (MR, MC), c
    lcd = ix.max_local_length(n, n_other)
    x3 = per_rank(lambda rk, x: _split(_pad_dim(x, 1, n_other * lcd), 1, lcd,
                                       n_other), A.local)
    y = x3 if n_other == 1 else all_to_all(x3, ax, 2, 2)
    lr = ix.max_local_length(m, S_row)

    def land(rk, y):
        z = _merge(y.movedim(2, 1), 0).narrow(0, 0, lr)
        gi = _arange(lr, z) * S_row + rank_of(dst[0], r, c, *rk)
        gj = _arange(lcd, z) * n_other + rank_of(dst[1], r, c, *rk)
        return torch.where((gi < m)[:, None] & (gj < n)[None, :], z, 0)
    return DistMatrix(per_rank(land, y), A.gshape, dst[0], dst[1], 0, 0, g)


def _t_meta(A: DistMatrix) -> DistMatrix:
    """Local transpose + swapped metadata (the [STAR,V] column forms ride
    the row kernels)."""
    m, n = A.gshape
    return DistMatrix(per_rank(lambda rk, x: x.mT, A.local), (n, m), A.rdist,
                      A.cdist, A.ralign, A.calign, A.grid)


def _fused_to_star_star(A: DistMatrix) -> DistMatrix | None:
    """[MC,MR] / [MR,MC] -> [STAR,STAR] in ONE all_gather over
    ('mc','mr') and a static interleave; None on 1-D grids."""
    g = A.grid
    r, c = g.height, g.width
    if r == 1 or c == 1:
        return None
    m, n = A.gshape
    mcmr = A.dist == (MC, MR)

    def interleave(rk, gx):
        lr, lc = gx.shape[1:]
        G = gx.reshape(r, c, lr, lc)
        if mcmr:    # global (i, j) = (il*r + mc, jl*c + mr)
            full = G.permute(2, 0, 3, 1).reshape(lr * r, lc * c)
        else:       # global (i, j) = (il*c + mr, jl*r + mc)
            full = G.permute(2, 1, 3, 0).reshape(lr * c, lc * r)
        return full[:m, :n]
    return DistMatrix(per_rank(interleave, all_gather(A.local, ("mc", "mr"))),
                      A.gshape, STAR, STAR, 0, 0, g)


def _fused_dispatch(A: DistMatrix, dst) -> DistMatrix | None:
    src = A.dist
    if src in ((MC, MR), (MR, MC)) and dst == (STAR, STAR):
        return _fused_to_star_star(A)
    if (src, dst) in (((MC, MR), (VC, STAR)), ((MR, MC), (VR, STAR))):
        return _fused_to_v(A)
    if (src, dst) in (((VC, STAR), (MC, MR)), ((VR, STAR), (MR, MC))):
        return _fused_from_v(A)
    if (src, dst) in (((MC, MR), (STAR, VR)), ((MR, MC), (STAR, VC))):
        return _t_meta(_fused_to_v(_t_meta(A)))
    if (src, dst) in (((STAR, VR), (MC, MR)), ((STAR, VC), (MR, MC))):
        return _t_meta(_fused_from_v(_t_meta(A)))
    return None


# ---------------------------------------------------------------------
# re-alignment (a ppermute rotation per dim)
# ---------------------------------------------------------------------

def _rot_perm(d: Dist, delta: int, r: int, c: int):
    """(axes, perm) rotating rank space by ``delta``: rank q receives from
    rank (q + delta) % S (the JAX ``redist.interior._rot_perm``)."""
    if d is MC:
        return "mc", [((q + delta) % r, q) for q in range(r)]
    if d is MR:
        return "mr", [((q + delta) % c, q) for q in range(c)]
    p = r * c
    if d is VC:
        lin = [(v % r) * c + v // r for v in range(p)]   # rank id of VC v
    elif d is VR:
        lin = list(range(p))                             # VR rank == rank id
    else:
        raise ValueError(f"no permute axes for {d}")
    return ("mc", "mr"), [(lin[(q + delta) % p], lin[q]) for q in range(p)]


def _realign(A: DistMatrix, calign: int, ralign: int) -> DistMatrix:
    """Change alignments: a wholesale rank rotation per dim."""
    g = A.grid
    r, c = g.height, g.width
    x = A.local
    for d, a_old, a_new in ((A.cdist, A.calign, calign),
                            (A.rdist, A.ralign, ralign)):
        S = dist_stride(d, r, c)
        if S == 1 or a_old == a_new:
            continue
        x = ppermute(x, *_rot_perm(d, (a_old - a_new) % S, r, c))
    return DistMatrix(x, A.gshape, A.cdist, A.rdist, calign, ralign, g)


# ---------------------------------------------------------------------
# whole-matrix operations
# ---------------------------------------------------------------------

def to_star_star(A: DistMatrix) -> DistMatrix:
    g = A.grid
    xg = _gather_dim(A.local, 0, A.cdist, A.calign, A.gshape[0], g)
    xg = _gather_dim(xg, 1, A.rdist, A.ralign, A.gshape[1], g)
    return DistMatrix(xg, A.gshape, STAR, STAR, 0, 0, g)


def _zero_padding(loc, gshape, cdist, rdist, calign, ralign, g, rk):
    """The padding-is-zero invariant on a freshly filtered block."""
    r, c = g.height, g.width
    Sc, Sr = dist_stride(cdist, r, c), dist_stride(rdist, r, c)
    if cdist is MD or rdist is MD:
        return loc        # _filter_md zero-fills everything out of range
    if loc.shape[0] * Sc != gshape[0]:
        gi = _arange(loc.shape[0], loc) * Sc \
            + ix.shift(rank_of(cdist, r, c, *rk), calign, Sc)
        loc = torch.where((gi < gshape[0])[:, None], loc, 0)
    if loc.shape[1] * Sr != gshape[1]:
        gj = _arange(loc.shape[1], loc) * Sr \
            + ix.shift(rank_of(rdist, r, c, *rk), ralign, Sr)
        loc = torch.where((gj < gshape[1])[None, :], loc, 0)
    return loc


def _from_star_star(xg: Tiles, gshape, cdist, rdist, calign, ralign,
                    g) -> DistMatrix:
    """Every rank filters its block out of its replicated copy."""
    r, c = g.height, g.width
    Sc, Sr = dist_stride(cdist, r, c), dist_stride(rdist, r, c)
    lr = ix.max_local_length(gshape[0], Sc)
    lc = ix.max_local_length(gshape[1], Sr)

    def filt(rk, x):
        if cdist is MD:
            loc = _filter_md(x, 0, gshape[0], r, c, rk)
        else:
            loc = _filter_dim(x, 0, Sc, ix.shift(rank_of(cdist, r, c, *rk),
                                                 calign, Sc), lr)
        if rdist is MD:
            loc = _filter_md(loc, 1, gshape[1], r, c, rk)
        else:
            loc = _filter_dim(loc, 1, Sr, ix.shift(rank_of(rdist, r, c, *rk),
                                                   ralign, Sr), lc)
        return _zero_padding(loc, gshape, cdist, rdist, calign, ralign, g, rk)
    return DistMatrix(per_rank(filt, xg), gshape, cdist, rdist, calign, ralign,
                      g)


def _retag(A: DistMatrix, dim: int, d: Dist, loc) -> DistMatrix:
    if dim == 0:
        return DistMatrix(loc, A.gshape, d, A.rdist, 0, A.ralign, A.grid)
    return DistMatrix(loc, A.gshape, A.cdist, d, A.calign, 0, A.grid)


def _vc_vr_permute(xs: Tiles, src: Dist, r: int, c: int) -> Tiles:
    """[VC,*] <-> [VR,*]: the residue class of VC rank v moves wholesale
    between its VC owner (rank (v%r)*c + v//r) and its VR owner (rank v):
    one ppermute over ('mc','mr')."""
    p = r * c
    if p == 1 or r == 1 or c == 1:
        return xs
    vc_dev = [(v % r) * c + v // r for v in range(p)]
    perm = [(vc_dev[v], v) for v in range(p)] if src is VC \
        else [(v, vc_dev[v]) for v in range(p)]
    return ppermute(xs, ("mc", "mr"), perm)


def _partial_ladder(A: DistMatrix, dim: int, src: Dist, dst: Dist):
    """[VC,*]<->[MC,*] / [VR,*]<->[MR,*] partial gathers / filters and the
    [VC]<->[VR] permutation (zero alignments); None otherwise."""
    g = A.grid
    r, c = g.height, g.width
    p = r * c
    extent = A.gshape[dim]
    if (src, dst) in ((VC, MC), (VR, MR)):
        axes = ("mr",) if src is VC else ("mc",)
        nblocks = c if src is VC else r
        l_out = ix.max_local_length(extent, r if src is VC else c)
        return _retag(A, dim, dst, _partial_gather_dim(A.local, dim, axes,
                                                       nblocks, l_out))
    if (src, dst) in ((MC, VC), (MR, VR)):
        nblocks = c if dst is VC else r
        l_out = ix.max_local_length(extent, p)
        loc = per_rank(lambda rk, x: _partial_filter_dim(
            x, dim, nblocks, rk[1] if dst is VC else rk[0], l_out), A.local)
        return _retag(A, dim, dst, loc)
    if {src, dst} == {VC, VR}:
        return _retag(A, dim, dst, _vc_vr_permute(A.local, src, r, c))
    return None


def _dim_change(A: DistMatrix, dim: int, new: Dist) -> DistMatrix | None:
    """Change one dimension's distribution, the other fixed (the JAX
    ``_rowdim_change`` / ``_coldim_change``)."""
    g = A.grid
    r, c = g.height, g.width
    src = A.dist[dim]
    extent = A.gshape[dim]
    if src is new:
        return A
    if src is STAR:                              # local filter
        S = dist_stride(new, r, c)
        ll = ix.max_local_length(extent, S)
        loc = per_rank(lambda rk, x: _filter_dim(
            x, dim, S, ix.shift(rank_of(new, r, c, *rk), 0, S), ll), A.local)
        return _retag(A, dim, new, loc)
    if new is STAR:                              # gather
        align = A.calign if dim == 0 else A.ralign
        return _retag(A, dim, STAR, _gather_dim(A.local, dim, src, align,
                                                extent, g))
    return _partial_ladder(A, dim, src, new)


def to_dist(A: DistMatrix, cdist: Dist, rdist: Dist, calign: int = 0,
            ralign: int = 0) -> DistMatrix:
    """``B[cdist,rdist] = A`` on a device grid: the JAX engine's
    ``to_dist`` dispatch, hop for hop."""
    from .engine import _CHAINS
    _check_pair(cdist, rdist)
    g = A.grid
    src, dst = A.dist, (cdist, rdist)
    if src == dst and (A.calign, A.ralign) == (calign, ralign):
        return A
    if MD in src + dst:
        if (calign, ralign) != (0, 0):
            raise ValueError("MD redistributions require zero alignments")
        ss = to_star_star(A)
        return _from_star_star(ss.local, A.gshape, cdist, rdist, 0, 0, g)
    if src == dst:
        return _realign(A, calign, ralign)
    if (A.calign, A.ralign) != (0, 0):
        return to_dist(_realign(A, 0, 0), cdist, rdist, calign, ralign)
    if (calign, ralign) != (0, 0):
        return _realign(to_dist(A, cdist, rdist, 0, 0), calign, ralign)
    out = _fused_dispatch(A, dst)
    if out is not None:
        return out
    if A.cdist is cdist:
        out = _dim_change(A, 1, rdist)
        if out is not None:
            return out
    if A.rdist is rdist:
        out = _dim_change(A, 0, cdist)
        if out is not None:
            return out
    chain = _CHAINS.get((src, dst))
    if chain is not None:
        out = A
        for hop in chain:
            out = to_dist(out, *hop)
        return out
    ss = to_star_star(A)
    return _from_star_star(ss.local, A.gshape, cdist, rdist, calign, ralign, g)


def redistribute(A: DistMatrix, cdist: Dist, rdist: Dist, calign: int,
                 ralign: int, wire=None) -> DistMatrix:
    """The device-grid body of :func:`..redist.engine.redistribute` (a
    change of layout on a grid of more than one rank): a CIRC endpoint
    goes through [STAR,STAR] on rank 0, and a ``'bf16'`` wire casts every
    rank's block before the moves and back after them."""
    g = A.grid
    if cdist is CIRC:
        star = to_dist(A, STAR, STAR)
        loc = rank_map(g, lambda rk, dev: star.local[0] if rk == (0, 0)
                       else star.local[0].new_zeros((0, 0), device=dev))
        return DistMatrix(loc, A.gshape, CIRC, CIRC, 0, 0, g)
    if A.cdist is CIRC:
        star = DistMatrix(broadcast(A.local, 0), A.gshape, STAR, STAR, 0, 0, g)
        return to_dist(star, cdist, rdist, calign, ralign)
    dt = A.dtype
    if wire == "bf16":
        A = A.with_local(per_rank(lambda rk, x: x.to(torch.bfloat16), A.local))
    out = to_dist(A, cdist, rdist, calign, ralign)
    if wire == "bf16":
        out = out.with_local(per_rank(lambda rk, x: x.to(dt), out.local))
    return out


def panel_spread(A: DistMatrix, conj: bool, wire=None):
    """The device-grid body of :func:`..redist.engine.panel_spread` (the
    JAX ``_panel_spread_to_pair``): ONE all_gather over ('mr','mc')
    rebuilds the [VC,STAR] panel on every rank; the [MC,STAR] spread and
    the [STAR,MR] adjoint are local filters of it."""
    g = A.grid
    m, k = A.gshape
    dt = A.dtype
    loc = A.local
    if wire == "bf16":
        loc = per_rank(lambda rk, x: x.to(torch.bfloat16), loc)
    full = _gather_dim(loc, 0, VC, 0, m, g)
    mc = _from_star_star(full, (m, k), MC, STAR, 0, 0, g)
    adj = per_rank(lambda rk, x: x.mT.conj_physical() if conj else x.mT, full)
    mr = _from_star_star(adj, (k, m), STAR, MR, 0, 0, g)
    if wire == "bf16":
        mc = mc.with_local(per_rank(lambda rk, x: x.to(dt), mc.local))
        mr = mr.with_local(per_rank(lambda rk, x: x.to(dt), mr.local))
    return mc, mr


def transpose_dist(A: DistMatrix, conj: bool) -> DistMatrix:
    """A^T tagged [rdist, cdist]: each rank transposes its own block (the
    slot a rank holds follows the distribution, not the dimension)."""
    loc = per_rank(lambda rk, x: x.mT.contiguous().conj_physical() if conj
                   else x.mT.contiguous(), A.local)
    m, n = A.gshape
    return DistMatrix(loc, (n, m), A.rdist, A.cdist, A.ralign, A.calign,
                      A.grid)
