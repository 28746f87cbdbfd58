"""LU with partial pivoting (HPL-style, look-ahead pipelined) + permutation
utilities.

PyTorch port of ``elemental_tpu/lapack/lu.py`` (Elemental
``src/lapack_like/factor/LU.cpp`` + ``LU/{Panel,SolveAfter}.hpp`` and
``src/lapack_like/perm/``), classic panel strategy.

The whole current panel is gathered to [STAR,STAR] and factored once
(replicated, deterministic), so the pivot search costs no communication;
the panel's composed row permutation is applied to the trailing rows as
one storage-level gather/scatter.  Every panel goes through
:func:`_panel_dispatch`: on a CUDA tensor with a real dtype it runs the
hand-written kernel (``kernels/csrc/lu_panel.cu``), elsewhere the plain
chunk ladder (:data:`~elemental_tpu_torch.kernels.DEFAULT_INNERS`).

Look-ahead (default on): step k's trailing update is split at the next
panel boundary -- the next panel's strip is updated first and factored,
then the wide remainder runs; both read the pre-writeback matrix, so
``lookahead=False`` (the classic order) gives the same factor up to
roundoff.  ``crossover``: once the distributed loop's trailing block is
at most this size, it is gathered once and finished with the sequential
schedule (default 4096 with look-ahead, off for classic; 0 disables).

PyTorch updates tensors in place and JAX never does: the sequential
schedule works on ONE clone of its input, so ``lu(A)`` never changes
``A.local``.  Nothing in the 1x1 loop syncs with the host: pivots stay
on the device, and :func:`_moved_rows` pads its index list by a stable
sort instead of ``nonzero``.

The packed L\\U layout and the permutation convention follow LAPACK getrf
(perm[i] = original index of the row now at position i).
:func:`lu_full_pivot` (complete pivoting) factors one replicated copy in
place, its pivot search and both permutations on the device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dist import MC, MR, STAR, VC, VR
from ..core.distmatrix import DistMatrix
from ..core.environment import check_precision
from ..core.view import view, update_view
from ..redist.engine import (_dtype_name, apply_fault, move_rows,
                             note_collective, permute_rows_storage,
                             redistribute)
from ..redist.quantize import quantizable
from ..blas.level1 import _global_indices
from ..blas.level3 import _check_mcmr, local_rank_update, trsm
from ..kernels import lu_panel as _kernel_lu_panel
from ..kernels import default_inners, resolve_panel
from ..kernels.lu_panel import _panel_lu, _panel_lu_unb  # noqa: F401
from ..obs.tracer import NULL_HOOK as _NULL_TIMER, phase_hook as _phase_hook
from ..tune.policy import blocksize_policy as _blocksize, resolve_auto
from .cholesky import _check_knobs

#: Trailing-block size at which the distributed loop gathers the tail and
#: finishes locally (look-ahead schedule only, unless overridden).
_CROSSOVER = 4096


# ---------------------------------------------------------------------
# permutation utilities (the DistPermutation analog)
# ---------------------------------------------------------------------

def permute_rows(B: DistMatrix, perm, inverse: bool = False) -> DistMatrix:
    """B[perm, :] as a DistMatrix (``DistPermutation::PermuteRows``): one
    storage-level gather for a zero-aligned [MC,MR] matrix."""
    _check_mcmr(B)
    return permute_rows_storage(B, perm, inverse=inverse)


def permute_cols(B: DistMatrix, perm, inverse: bool = False) -> DistMatrix:
    """B[:, perm] as a DistMatrix (``DistPermutation::PermuteCols``), via
    [VC,STAR], where columns are replicated."""
    _check_mcmr(B)
    Bvc = redistribute(B, VC, STAR)
    p = torch.as_tensor(perm, device=B.local.device).to(torch.int64)
    if inverse:
        p = torch.argsort(p)
    return redistribute(Bvc.with_local(Bvc.local[:, p]), MC, MR)


def _apply_swaps_moved(A: DistMatrix, T, S, valid) -> DistMatrix:
    """Move global rows ``S`` to positions ``T`` in one pass, dropping
    entries where ``valid`` is False (the engine's ``move_rows``)."""
    return move_rows(A, T, S, valid)


# ---------------------------------------------------------------------
# panel factorization
# ---------------------------------------------------------------------

def _panel_dispatch(P, nbw: int, precision=None, plan=None):
    """One replicated panel through the resolved ``panel_impl`` plan: the
    CUDA kernel (chunked at ``plan.kernel_inner``) when the plan selects
    it for the panel's dtype, else the plain chunk ladder with the plan's
    ``inners``.  ``plan=None`` is the plain ladder."""
    if plan is not None and plan.use_kernel(P.dtype):
        return _kernel_lu_panel(P, nbw, precision, inner=plan.kernel_inner)
    inners = plan.inners if plan is not None else default_inners()
    return _panel_lu(P, nbw, precision, inners)


def _unit_lower_inv(L11, nbw: int, precision=None, bs: int = 256):
    """Inverse of a unit-lower (nbw, nbw) block, assembled by matmuls with
    triangular solves only on ``bs`` diagonal blocks -- turns the
    U12 := L11^{-1} A12 panel solve into one matmul."""
    eye = torch.eye(nbw, dtype=L11.dtype, device=L11.device)
    if nbw <= bs:
        return torch.linalg.solve_triangular(L11, eye, upper=False,
                                             unitriangular=True)
    Li = torch.zeros_like(eye)
    for s in range(0, nbw, bs):
        e = min(s + bs, nbw)
        Likk = torch.linalg.solve_triangular(L11[s:e, s:e], eye[s:e, s:e],
                                             upper=False, unitriangular=True)
        if s > 0:
            Li[s:e, :s] = -(Likk @ (L11[s:e, :s] @ Li[:s, :s]))
        Li[s:e, s:e] = Likk
    return Li


def _moved_rows(pperm, nbw: int):
    """Indices (into the trailing block) the composed panel permutation
    displaces, padded to ``min(2 nbw, M)`` with the sentinel M, and their
    sources.  A composition of nbw swaps moves at most 2 nbw rows; a
    stable sort on the "not moved" flag lists the moved ones first, in
    order, with no host sync (the JAX package's ``nonzero(size=,
    fill_value=)``)."""
    M = pperm.shape[0]
    k = min(2 * nbw, M)
    moved = pperm != torch.arange(M, device=pperm.device)
    order = torch.argsort((~moved).to(torch.int8), stable=True)[:k]
    idx = torch.where(moved[order], order, M)
    src = pperm[idx.clamp(0, M - 1)]
    return idx, src


# ---------------------------------------------------------------------
# CALU tournament-pivoted panel (communication-avoiding LU, Grigori /
# Demmel / Xiang): each grid row factors its cyclic slab of the panel with
# partial pivoting, the per-slab candidate pivot blocks reduce in a
# log-depth pairwise playoff, and the winners are applied as ONE composed
# row permutation; the permuted panel then factors without pivoting
# ---------------------------------------------------------------------

def _sweep(V, piv, rows):
    """In place: the partial-pivot sweep of each block of ``V`` (B, Mp, w)
    over ``piv.shape[0]`` columns, the trailing block only (the JAX
    package's ``fori_loop`` updates the masked whole block: the same
    values).  ``piv[j]`` receives column j's pivot offset from j; ``rows``
    (n, B) holds row j of each block in the flattened ``V``.  Twelve
    plain kernels a column: the pivot search and its record, the row swap
    as two row gathers and two row copies, the guarded division in place
    and one rank-1 update; all-zero padding rows flow through as zeros."""
    B, Mp, w = V.shape
    Vf = V.view(B * Mp, w)
    for j in range(piv.shape[0]):
        rj = rows[j]
        p = V[:, j:, j].abs().argmax(dim=1)
        piv[j].copy_(p)
        rp = rj + p
        row_p, row_j = Vf.index_select(0, rp), Vf.index_select(0, rj)
        Vf.index_copy_(0, rj, row_p)
        Vf.index_copy_(0, rp, row_j)
        d = V[:, j, j]
        l = V[:, j + 1:, j]
        l.div_(torch.where(d == 0, 1, d)[:, None])
        V[:, j + 1:, j + 1:].addcmul_(l[:, :, None], V[:, j, None, j + 1:],
                                      value=-1)


#: most sweep graphs a cache holds: the current round-0 slab shape and
#: the log2 r playoff shapes (r <= 8); the least recently used goes first
_SWEEP_GRAPHS_MAX = 4


def _sweep_pivots(V, n: int, graphs: dict | None = None):
    """(n, B) pivot offsets of the sweep of ``V`` (left unchanged).  On
    the CPU the sweep runs eagerly; on the card it is captured once per
    block shape as one CUDA graph and replayed after, so a panel of the
    tournament costs its kernels' device time, not ~10^5 launches from
    the host.  ``graphs`` is the caller's cache, (B, Mp, w, n, dtype,
    device) -> (graph, V, piv, rows) with the static tensors the graph
    reads and writes; ``lu`` keeps one for the length of a call, so
    nothing stays resident after it returns (``None``: a cache for this
    call only)."""
    B, Mp, w = V.shape
    dev = V.device
    if not V.is_cuda:
        piv = torch.empty((n, B), dtype=torch.int64, device=dev)
        rows = (torch.arange(B, device=dev)[None, :] * Mp
                + torch.arange(n, device=dev)[:, None])
        _sweep(V.clone(), piv, rows)
        return piv
    graphs = {} if graphs is None else graphs
    key = (B, Mp, w, n, V.dtype, dev)
    entry = graphs.pop(key, None)
    if entry is None:
        while len(graphs) >= _SWEEP_GRAPHS_MAX:
            graphs.pop(next(iter(graphs)))
        Vs = V.clone()
        piv = torch.empty((n, B), dtype=torch.int64, device=dev)
        rows = (torch.arange(B, device=dev)[None, :] * Mp
                + torch.arange(n, device=dev)[:, None])
        # two columns on a side stream are the warm-up capture needs
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _sweep(V.clone(), piv[:min(n, 2)], rows)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _sweep(Vs, piv, rows)
        entry = (graph, Vs, piv, rows)
    graphs[key] = entry                                  # most recent last
    graph, Vs, piv, _ = entry
    Vs.copy_(V)
    graph.replay()
    return piv


def _playoff_perm(V, ncol: int, graphs: dict | None = None):
    """Pivot ORDER of a partial-pivot LU sweep over each of a batch of
    (possibly zero-padded) blocks ``V`` (B, Mp, w): the composed
    permutations (B, Mp) as a host numpy array (the factor values are
    discarded -- playoffs select rows).  The swaps are composed on the
    host from the pivot list of :func:`_sweep_pivots`, one transfer per
    call."""
    B, Mp, w = V.shape
    n = min(ncol, Mp)
    perm = np.tile(np.arange(Mp), (B, 1))
    if n == 0:
        return perm
    pv = _sweep_pivots(V, n, graphs).cpu().numpy().T + np.arange(n)[None, :]
    ar = np.arange(B)
    for j in range(n):
        pj, pp = perm[ar, j].copy(), perm[ar, pv[:, j]].copy()
        perm[ar, j] = pp
        perm[ar, pv[:, j]] = pj
    return perm


def _tournament_pivots(P, nbw: int, r: int, graphs: dict | None = None):
    """The CALU tournament: the composed panel permutation (perm[i] =
    original row now at position i), a length-M int64 tensor whose first
    ``nbw`` entries are the playoff winners.  Slab membership mirrors the
    [MC,*] ownership map (global row i lives in grid row i % r), so the
    tournament selects exactly the pivots a message-passing CALU over the
    grid rows would.  ``graphs`` is the sweep-graph cache
    (:func:`_sweep_pivots`)."""
    M = P.shape[0]
    dev = P.device
    graphs = {} if graphs is None else graphs
    # slabs padded with zero rows to a multiple of nbw: the sweep never
    # prefers an appended zero row to an earlier one, so the winners are
    # those of the unpadded slabs, and the card reuses one graph of the
    # sweep for every panel height in a band of nbw r rows
    lslab = -(-max(-(-M // r), nbw) // nbw) * nbw
    sidx = (torch.arange(lslab, device=dev)[None, :] * r
            + torch.arange(r, device=dev)[:, None])
    ok = sidx < M                                        # (r, lslab)
    vals = torch.where(ok[:, :, None], P[sidx.clamp(0, M - 1)], 0)
    gidx = torch.where(ok, sidx, M)                      # sentinel M = padding
    # round 0: every slab's local partial-pivot sweep
    top = torch.as_tensor(_playoff_perm(vals, nbw, graphs)[:, :nbw], device=dev)
    cvals = torch.take_along_dim(vals, top[:, :, None], dim=1)
    cidx = torch.take_along_dim(gidx, top, dim=1)        # (r, nbw)
    # log-depth pairwise playoffs (an odd participant gets a bye)
    nblk = r
    while nblk > 1:
        half, odd = nblk // 2, nblk % 2
        st_v = torch.cat([cvals[:half], cvals[half:2 * half]], dim=1)
        st_i = torch.cat([cidx[:half], cidx[half:2 * half]], dim=1)
        wtop = torch.as_tensor(_playoff_perm(st_v, nbw, graphs)[:, :nbw], device=dev)
        wv = torch.take_along_dim(st_v, wtop[:, :, None], dim=1)
        wi = torch.take_along_dim(st_i, wtop, dim=1)
        if odd:
            wv = torch.cat([wv, cvals[2 * half:]], dim=0)
            wi = torch.cat([wi, cidx[2 * half:]], dim=0)
        cvals, cidx = wv, wi
        nblk = half + odd
    # compose the one-shot permutation: winner j swaps into position j (a
    # padding sentinel is a no-op swap; only on exactly-singular panels)
    win = cidx[0].cpu().numpy()
    perm, invp = np.arange(M), np.arange(M)
    for j in range(nbw):
        w = int(win[j]) if win[j] < M else int(perm[j])
        tp, pj = int(invp[w]), int(perm[j])
        perm[j], perm[tp] = w, pj
        invp[w], invp[pj] = j, tp
    return torch.as_tensor(perm, device=dev)


def _lu_nopiv(W, bs: int = 256):
    """Unpivoted blocked LU of a square block (packed L\\U, unit-lower L):
    the tournament already fixed the pivot order, so diagonal blocks run
    the plain recurrence, off-diagonal blocks are triangular solves and
    one matmul per step."""
    W = W.clone()
    b = W.shape[0]

    def unb(B):                                          # in place
        for j in range(B.shape[0]):
            l = B[j + 1:, j]
            l.div_(B[j, j])
            B[j + 1:, j + 1:].addcmul_(l[:, None], B[j, None, j + 1:],
                                       value=-1)
        return B

    if b <= bs:
        return unb(W)
    for s in range(0, b, bs):
        e = min(s + bs, b)
        blk = unb(W[s:e, s:e])
        if e < b:
            W[s:e, e:] = torch.linalg.solve_triangular(
                blk, W[s:e, e:], upper=False, unitriangular=True)
            W[e:, s:e] = torch.linalg.solve_triangular(
                torch.triu(blk), W[e:, s:e], upper=True, left=False)
            W[e:, e:].addmm_(W[e:, s:e], W[s:e, e:], alpha=-1)
    return W


def _upper_inv(U, nbw: int, bs: int = 256):
    """Inverse of a non-unit upper-triangular block, assembled by matmuls
    with triangular solves only on ``bs`` diagonal blocks -- turns the
    CALU ``L21 := A21 U11^{-1}`` panel solve into one matmul."""
    eye = torch.eye(nbw, dtype=U.dtype, device=U.device)
    if nbw <= bs:
        return torch.linalg.solve_triangular(U, eye, upper=True)
    Ui = torch.zeros_like(eye)
    for s in range(0, nbw, bs):
        e = min(s + bs, nbw)
        Uikk = torch.linalg.solve_triangular(U[s:e, s:e], eye[s:e, s:e],
                                             upper=True)
        if s > 0:
            Ui[:s, s:e] = -((Ui[:s, :s] @ U[:s, s:e]) @ Uikk)
        Ui[s:e, s:e] = Uikk
    return Ui


def _nopiv_panel(Pp, nbw: int):
    """Unpivoted factorization of an already-permuted (M, nbw) panel:
    packed ``[L11\\U11; L21]`` with ``L21 = A21 U11^{-1}`` as one matmul.
    Shared by the CALU panel (winners on top) and the TSQR Householder
    reconstruction in ``qr.py`` (LU of ``Q1 - S``)."""
    Wf = _lu_nopiv(Pp[:nbw])
    Ui = _upper_inv(torch.triu(Wf), nbw)
    return torch.cat([Wf, Pp[nbw:] @ Ui], dim=0)


def _calu_panel(P, nbw: int, r: int, precision=None, plan=None,
                graphs: dict | None = None, tm=_NULL_TIMER, step: int = 0):
    """CALU panel factorization of a replicated (M, nbw) panel: the
    tournament over ``r`` grid-row slabs, then the unpivoted factor of
    the permuted panel; ``tm`` ticks the tournament phase between the
    two.  Same ``(packed, perm)`` contract as the classic panel; with
    ``r == 1`` (or a panel no taller than wide) the tournament IS partial
    pivoting, so the classic panel runs through :func:`_panel_dispatch`
    (``plan`` picks the CUDA kernel on the card)."""
    M = P.shape[0]
    if r <= 1 or M <= nbw:
        return _panel_dispatch(P, nbw, precision, plan)
    perm = _tournament_pivots(P, nbw, r, graphs)
    tm.tick("tournament", step, perm)
    return _nopiv_panel(P.index_select(0, perm), nbw), perm


def _rowblock_solve(Ablk: DistMatrix, Li11, wire=None) -> DistMatrix:
    """``U = Li11 @ Ablk`` for an (nbw, w) [MC,MR] row block, landing
    [STAR,MR]: each grid row contracts the replicated ``Li11`` against only
    the block rows it stores (columns ``mc + r * iLoc`` of ``Li11``), and
    the r partial products are summed -- ONE psum over the grid column on
    a real grid, where the classic schedule needs an all-to-all and an
    all-gather.  ``wire='bf16'`` rounds each partial to bfloat16 and the
    sum to bfloat16, as the JAX psum on a bfloat16 payload; the sum runs
    in float32 in grid-row order (XLA's psum order may differ)."""
    g = Ablk.grid
    r = g.height
    nbw = Ablk.gshape[0]
    x = Ablk.local
    lr = x.shape[0] // r
    cols = (torch.arange(r, device=x.device)[:, None]
            + r * torch.arange(lr, device=x.device)[None, :])   # (r, lr)
    Lsub = Li11[:, cols.clamp(0, nbw - 1)].permute(1, 0, 2)    # (r, nbw, lr)
    Lsub = torch.where((cols < nbw)[:, None, :], Lsub, 0)
    parts = torch.bmm(Lsub, x.reshape(r, lr, x.shape[1]))       # (r, nbw, *)
    note_collective("psum", r, (nbw, x.shape[1] // g.width),
                    2 if wire == "bf16" else x.element_size(), ("mc",),
                    "bfloat16" if wire == "bf16" else _dtype_name(x.dtype))
    if wire == "bf16":
        out = parts.to(torch.bfloat16).to(torch.float32).sum(0) \
            .to(torch.bfloat16).to(x.dtype)
    else:
        out = parts.sum(0)
    return DistMatrix(out, Ablk.gshape, STAR, MR, 0, Ablk.ralign, g)


# ---------------------------------------------------------------------
# blocked right-looking LU with look-ahead
# ---------------------------------------------------------------------

def _local_lu(A: DistMatrix, nb: int | None, precision, update_precision=None,
              lookahead: bool = True, timer=None, plan=None):
    """Sequential (p == 1) path: on a 1x1 grid the storage array IS the
    global matrix, so the blocked loop runs on it directly."""
    a, perm = _local_lu_array(A.local, A.gshape[0], A.gshape[1],
                              max(nb or 1024, 1), precision,
                              update_precision, lookahead, timer, plan)
    return A.with_local(a), perm


def _local_lu_array(a, m: int, n: int, ib: int, precision,
                    update_precision=None, lookahead: bool = True,
                    timer=None, plan=None):
    """Blocked LU of a plain (replicated) array: the sequential engine
    behind both the 1x1-grid path and the distributed loop's
    crossover-to-local tail.  Returns ``(packed LU, perm)`` as new
    tensors.

    Works in place on one copy of ``a`` with a spare last row: a panel's
    swaps move only the rows :func:`_moved_rows` lists (at most 2 nbw,
    the sentinel entries land in the spare row), where the JAX package
    gathers the whole trailing block -- the same permutation, a fraction
    of the bytes.  The trailing products accumulate into ``a`` in place
    (``addmm_``)."""
    kend = min(m, n)
    buf = a.new_empty((m + 1, n))
    buf[:m].copy_(a[:m, :n])
    a = buf[:m]
    perm = torch.arange(m, device=a.device)
    tm = timer if timer is not None else _NULL_TIMER
    tm.start()
    if lookahead:
        w0 = min(ib, kend)
        nxt = _panel_dispatch(a[:, :w0], w0, precision, plan)
        tm.tick("panel", 0, nxt)
    for k, s in enumerate(range(0, kend, ib)):
        e = min(s + ib, kend)
        nbw = e - s
        if lookahead:
            Pf, pperm = nxt
        else:
            Pf, pperm = _panel_dispatch(a[s:, s:e], nbw, precision, plan)
            tm.tick("panel", k, Pf, pperm)
        perm[s:] = perm[s:].index_select(0, pperm)
        # the displaced rows (all columns), then the factored panel
        idx, src = _moved_rows(pperm, nbw)
        buf.index_copy_(0, idx + s, buf.index_select(0, src + s))
        tm.tick("swap", k, a)
        a[s:, s:e] = Pf
        if e >= n:
            continue
        Li11 = _unit_lower_inv(Pf[:nbw], nbw, precision)
        U1n = Li11 @ a[s:e, e:]
        tm.tick("solve", k, U1n)
        if not lookahead or e >= kend:
            a[s:e, e:] = U1n
            if e < m:
                a[e:, e:].addmm_(Pf[nbw:], U1n, alpha=-1)
                tm.tick("update", k, a)
            continue
        # look-ahead: (a) narrow strip update -> factor panel k+1 -> (b) the
        # wide remainder update; both read the pre-writeback ``a``
        e2 = min(e + ib, kend)
        w = e2 - e
        L21 = Pf[nbw:]
        strip = torch.addmm(a[e:, e:e2], L21, U1n[:, :w], alpha=-1)
        nxt = _panel_dispatch(strip, w, precision, plan)
        tm.tick("panel", k + 1, nxt)
        a[s:e, e:] = U1n
        if e2 < n:
            a[e:, e2:].addmm_(L21, U1n[:, w:], alpha=-1)
        # the strip region a[e:, e:e2] is dead: step k+1's swap and panel
        # writeback overwrite it
        tm.tick("update", k, a)
    return a, perm


def _blend_update(A: DistMatrix, block: DistMatrix, rows, cols, keep_new):
    cur = view(A, rows=rows, cols=cols)
    _, J = _global_indices(cur)
    mask = keep_new(J)[None, :]
    return update_view(A, cur.with_local(torch.where(mask, block.local,
                                                     cur.local)),
                       rows=rows, cols=cols)


def _update_cols_lt(A, block, rows, cols, e):
    """Write ``block`` into the view, only at global columns < e."""
    if cols[1] == e:
        return update_view(A, block, rows=rows, cols=cols)
    return _blend_update(A, block, rows, cols, lambda J: J < e - cols[0])


def _update_cols_ge(A, block, rows, cols, e):
    """Write ``block`` into the view, only at global columns >= e."""
    return _blend_update(A, block, rows, cols, lambda J: J >= e - cols[0])


def _check_lu_knobs(panel, update_precision, comm_precision,
                    redist_path) -> str:
    """Check the knobs (``'auto'`` already resolved); return the panel
    strategy."""
    _check_knobs(comm_precision, redist_path)
    if panel is None:
        panel = "classic"
    if panel not in ("classic", "calu"):
        raise ValueError(f"lu: unknown panel strategy {panel!r}; "
                         "expected 'classic', 'calu', or 'auto'")
    check_precision(update_precision)
    return panel


def lu(A: DistMatrix, nb: int | None = None, precision=None,
       update_precision=None, lookahead: bool = True,
       crossover: int | None = None, panel: str = "classic",
       panel_impl: str | None = None, inners=None,
       comm_precision: str | None = None, redist_path: str | None = None,
       timer=None, health=None, abft=None):
    """Blocked right-looking LU with partial pivoting and look-ahead.

    Returns ``(LU, perm)``: LU holds unit-lower L below the diagonal and U
    on and above it (LAPACK getrf packing); perm is a length-m int64
    tensor on the grid's device with ``(P A)[i] = A[perm[i]]``, so
    ``P A = L U``.

    ``lookahead`` selects the pipelined schedule; ``crossover`` is the
    trailing-block size at which the distributed loop gathers the rest
    once and finishes it sequentially (``None`` = :data:`_CROSSOVER` with
    look-ahead, disabled classic; 0 never crosses over).

    ``panel`` is ``'classic'`` (the replicated partial-pivot panel) or
    ``'calu'``: tournament pivoting (:func:`_tournament_pivots`) over the
    r grid-row slabs, one batched row permutation per panel, the
    unpivoted refactorization (:func:`_nopiv_panel`) and the one-psum
    row-block solve (:func:`_rowblock_solve`).  On a single-row grid
    (r == 1, 1x1 included) the tournament of one slab IS partial
    pivoting, so ``'calu'`` runs the classic panel; the crossover tail
    finishes with the classic panel under either strategy.

    ``panel_impl`` (``None`` | ``'auto'`` | ``'torch'`` | ``'kernel'``)
    selects the panel implementation; ``None`` and ``'auto'`` take the
    CUDA kernel for a real dtype on the card and the plain chunk ladder
    elsewhere (``None`` by device, ``'auto'`` through the tuner).
    ``inners`` overrides the ladder
    (:data:`~elemental_tpu_torch.kernels.DEFAULT_INNERS`); the kernel
    chunks at its finest rung.

    ``precision`` and ``update_precision`` are ``None`` or ``'highest'``
    (full float32/float64 arithmetic); on the card
    ``torch.backends.cuda.matmul.allow_tf32`` must be False.

    ``comm_precision`` (``None`` | ``'bf16'`` | ``'int8'``) selects the
    wire precision of the schedule's bulk moves (panel gathers, the U12
    row-block transport, the crossover gather; the CALU row-block psum
    rides ``'bf16'`` under either mode) and ``redist_path`` (``None`` |
    ``'chain'`` | ``'direct'``) their route, as in the JAX driver.

    ``health`` attaches the numerical-health guards
    (:mod:`..resilience.health`): a ``HealthMonitor`` (read
    ``monitor.report()`` afterwards) or ``True`` (the report lands in
    ``resilience.last_health_report('lu')``); ``None`` attaches nothing.
    ``abft`` (``True`` or an ``AbftGuard``) runs the checksum-guarded
    schedule with per-panel rollback
    (:func:`..resilience.abft.abft_lu`): the classic right-looking order
    on every grid, 1x1 included (``lookahead``, ``crossover`` and
    ``panel='calu'`` are ignored).

    Any of ``nb`` / ``lookahead`` / ``crossover`` / ``panel`` /
    ``comm_precision`` / ``redist_path`` / ``panel_impl`` may be
    ``'auto'``: the tuner (:mod:`..tune`) resolves them (measured cache
    first, analytic cost model cold; explicit values always win).
    ``timer`` (a :class:`~..obs.PhaseTimer`) receives the phase ticks
    (panel / swap / solve / update / tail; ``tournament`` under CALU),
    as does an active :class:`~..obs.Tracer`."""
    _check_mcmr(A)
    nb, lookahead, crossover, panel, panel_impl, comm_precision, \
        redist_path = resolve_auto(
            "lu", A.gshape, A.dtype, A.grid, nb=nb, lookahead=lookahead,
            crossover=crossover, panel=panel, panel_impl=panel_impl,
            comm_precision=comm_precision, redist_path=redist_path).values()
    g = A.grid
    r, c = g.height, g.width
    panel = _check_lu_knobs(panel, update_precision, comm_precision,
                            redist_path)
    check_precision(precision, A.local)
    plan = resolve_panel(panel_impl, dtype=A.dtype, device=A.local.device,
                         inners=inners)
    if abft:
        from ..resilience.abft import abft_lu
        return abft_lu(A, nb=nb, precision=precision,
                       update_precision=update_precision,
                       comm_precision=comm_precision, timer=timer,
                       health=health, abft=abft, plan=plan)
    m, n = A.gshape
    tm = _phase_hook("lu", timer)
    hm = None
    if health:
        from ..resilience.health import attach_health
        tm, hm = attach_health("lu", health, tm, scale_from=A)
    if g.size == 1:
        out = _local_lu(A, nb, precision, update_precision, lookahead, tm,
                        plan)
        if hm is not None:
            hm.report()
        return out
    calu = panel == "calu" and r > 1
    cp, rp = comm_precision, redist_path
    sweeps: dict = {}                # this call's sweep graphs (CALU, card)

    def factor_panel(Ploc, w: int, step: int):
        if calu:
            Pf, pperm = _calu_panel(Ploc, w, r, precision, plan, sweeps, tm,
                                    step)
        else:
            Pf, pperm = _panel_dispatch(Ploc, w, precision, plan)
        Pf, = apply_fault("compute", (Pf,))
        return Pf, pperm

    ib = _blocksize(nb, math.lcm(r, c), min(m, n))
    kend = min(m, n)
    dev = A.local.device
    perm = torch.arange(m, device=dev)
    xover = (_CROSSOVER if lookahead else 0) if crossover is None \
        else max(int(crossover), 0)
    tm.start()

    def col_up(e):
        # views start/end on stride boundaries: a ragged diagonal end is
        # widened to a legal boundary and the writebacks column-masked
        return min(-(-e // c) * c, n)

    if lookahead:
        e0_up = col_up(min(ib, kend))
        panel0 = redistribute(view(A, rows=(0, m), cols=(0, e0_up)),
                              STAR, STAR, comm_precision=cp, path=rp)
        nxt = factor_panel(panel0.local[:, :min(ib, kend)], min(ib, kend), 0)
        tm.tick("panel", 0, nxt)
    for k, s in enumerate(range(0, kend, ib)):
        e = min(s + ib, kend)
        nbw = e - s
        e_up = col_up(e)
        tail = bool(xover) and e < kend and m - e <= xover and n - e <= xover
        if lookahead:
            Pf, pperm = nxt
        else:
            pan = redistribute(view(A, rows=(s, m), cols=(s, e_up)),
                               STAR, STAR, comm_precision=cp, path=rp)
            Pf, pperm = factor_panel(pan.local[:, :nbw], nbw, k)
            tm.tick("panel", k, Pf, pperm)
        perm[s:] = perm[s:].index_select(0, pperm)
        # move only the rows the panel permutation displaced (<= 2 nbw)
        # across ALL columns (the panel region is overwritten right after)
        idx, src = _moved_rows(pperm, nbw)
        valid = idx < (m - s)
        A = _apply_swaps_moved(A, idx + s, src.clamp(0, m - s - 1) + s,
                               valid)
        tm.tick("swap", k, A)
        # write back the factored panel (rows s..m of cols s..e)
        Pf_w = torch.nn.functional.pad(Pf, (0, e_up - e)) if e_up > e else Pf
        Pf_ss = DistMatrix(Pf_w, (m - s, e_up - s), STAR, STAR, 0, 0, g)
        A = _update_cols_lt(A, redistribute(Pf_ss, MC, MR), (s, m),
                            (s, e_up), e)
        if e >= n:
            continue
        # U12 := L11^{-1} A12 over the legal column range (s, n); the
        # writeback keeps only cols >= e
        Li11 = _unit_lower_inv(Pf[:nbw], nbw, precision)
        if calu:
            # one-psum row-block solve in place of the all-to-all +
            # all-gather pair below
            U1n_mr = _rowblock_solve(
                view(A, rows=(s, e), cols=(s, n)), Li11,
                "bf16" if cp and quantizable(A.dtype) else None)
        else:
            A1n = redistribute(view(A, rows=(s, e), cols=(s, n)), STAR, VR,
                               comm_precision=cp, path=rp)
            U1n = DistMatrix(Li11 @ A1n.local, (nbw, n - s), STAR, VR, 0, 0,
                             g)
            U1n_mr = redistribute(U1n, STAR, MR, comm_precision=cp, path=rp)
        tm.tick("solve", k, U1n_mr)
        if not lookahead or e >= kend:
            A = _update_cols_ge(A, redistribute(U1n_mr, MC, MR), (s, e),
                                (s, n), e)
            if e < m:
                U12_mr = view(U1n_mr, cols=(e - s, n - s))
                L21_ss = DistMatrix(Pf[nbw:], (m - e, nbw), STAR, STAR,
                                    0, 0, g)
                L21_mc = redistribute(L21_ss, MC, STAR)
                A = local_rank_update(A, L21_mc.local, U12_mr.local,
                                      rows=(e, m), cols=(e, n))
                tm.tick("update", k, A)
            if tail:
                A, perm = _lu_tail(A, perm, e, ib, precision,
                                   update_precision, lookahead, tm, k, cp,
                                   rp, plan)
                break
            continue
        # look-ahead: split the trailing update at the next panel boundary;
        # every operand is read from the pre-writeback A
        e2 = min(e + ib, kend)
        e2_up = col_up(e2)
        L21_ss = DistMatrix(Pf[nbw:], (m - e, nbw), STAR, STAR, 0, 0, g)
        L21_mc = redistribute(L21_ss, MC, STAR)
        U12a = view(U1n_mr, cols=(e - s, e2_up - s))
        A22a = view(A, rows=(e, m), cols=(e, e2_up))
        stripD = A22a.with_local(A22a.local - L21_mc.local @ U12a.local)
        if not tail:
            strip_ss = redistribute(stripD, STAR, STAR, comm_precision=cp,
                                    path=rp)
            nxt = factor_panel(strip_ss.local[:, :e2 - e], e2 - e, k + 1)
            tm.tick("panel", k + 1, nxt)
        restD = None
        if e2_up < n:
            U12b = view(U1n_mr, cols=(e2_up - s, n - s))
            A22b = view(A, rows=(e, m), cols=(e2_up, n))
            restD = A22b.with_local(A22b.local - L21_mc.local @ U12b.local)
        A = _update_cols_ge(A, redistribute(U1n_mr, MC, MR), (s, e),
                            (s, n), e)
        A = update_view(A, stripD, rows=(e, m), cols=(e, e2_up))
        if restD is not None:
            A = update_view(A, restD, rows=(e, m), cols=(e2_up, n))
        tm.tick("update", k, A)
        if tail:
            A, perm = _lu_tail(A, perm, e, ib, precision, update_precision,
                               lookahead, tm, k, cp, rp, plan)
            break
    if hm is not None:
        hm.report()
    return A, perm


def _lu_tail(A: DistMatrix, perm, e: int, ib: int, precision,
             update_precision, lookahead: bool, tm, k: int,
             comm_precision=None, redist_path=None, plan=None):
    """Crossover-to-local finish of the (fully updated) trailing block:
    one [STAR,STAR] gather of rows/cols >= e, the sequential blocked
    kernel, one storage-level row permutation of the already-factored
    left columns, and the factored tail written back."""
    m, n = A.gshape
    g = A.grid
    Atail = redistribute(view(A, rows=(e, m), cols=(e, n)), STAR, STAR,
                         comm_precision=comm_precision, path=redist_path)
    at, pt = _local_lu_array(Atail.local, m - e, n - e, ib, precision,
                             update_precision, lookahead, plan=plan)
    dev = A.local.device
    # the tail's permutation applies to the WHOLE row range; cols >= e are
    # overwritten by the factored tail right after
    A = _apply_swaps_moved(A, torch.arange(m - e, device=dev) + e, pt + e,
                           torch.ones(m - e, dtype=torch.bool, device=dev))
    At_ss = DistMatrix(at, (m - e, n - e), STAR, STAR, 0, 0, g)
    A = update_view(A, redistribute(At_ss, MC, MR), rows=(e, m), cols=(e, n))
    perm[e:] = perm[e:].index_select(0, pt)
    tm.tick("tail", k, A)
    return A, perm


def lu_solve(A: DistMatrix, B: DistMatrix, nb: int | None = None,
             precision=None, panel: str = "classic", info: bool = False,
             health=None):
    """Solve A X = B via LU with partial pivoting (``El::LinearSolve``:
    LU + SolveAfter).

    ``info=True`` returns ``(X, info)`` where ``info`` is the structured
    singularity signal ``{"singular", "diag_index", "finite"}`` from the
    factor's diagonal (an exactly-singular A surfaces as a zero pivot
    instead of a silently NaN/Inf X); ``health`` forwards to :func:`lu`.
    For the residual-certified path use
    ``elemental_tpu_torch.resilience.certified_solve('lu', A, B)``."""
    LU_, perm = lu(A, nb=nb, precision=precision, panel=panel, health=health)
    X = lu_solve_after(LU_, perm, B, nb=nb, precision=precision)
    if not info:
        return X
    from ..resilience.health import factor_diag_info
    return X, factor_diag_info("lu", LU_)


def lu_solve_after(LU_: DistMatrix, perm, B: DistMatrix,
                   nb: int | None = None, precision=None) -> DistMatrix:
    """X = U^{-1} L^{-1} P B (``lu::SolveAfter``)."""
    Bp = permute_rows(B, perm)
    Y = trsm("L", "L", "N", LU_, Bp, unit=True, nb=nb, precision=precision)
    return trsm("L", "U", "N", LU_, Y, nb=nb, precision=precision)


def lu_full_pivot(A: DistMatrix, precision=None):
    """LU with COMPLETE pivoting: ``P A Q = L U`` with the pivot the
    largest remaining |entry| each step (``lu::Full``, Elemental
    ``src/lapack_like/factor/LU/Full.hpp``).

    Returns ``(LU, rperm, cperm)`` with the getrf-style packed factor and
    row/column permutations: ``(P A Q)[i, j] = A[rperm[i], cperm[j]]``.

    Runs REPLICATED on one gathered copy, in place, with the pivot search
    (``argmax`` of the trailing block, the first index of a tie in
    row-major order, as the JAX package's masked flat ``argmax``) and
    both permutations on the device; each step updates only the trailing
    block, which is all the JAX package's full-matrix outer product
    changes.  The slow, maximum-stability path; use :func:`lu` for
    speed."""
    _check_mcmr(A)
    check_precision(precision, A.local)
    m, n = A.gshape
    kend = min(m, n)
    g = A.grid
    a = redistribute(A, STAR, STAR).local.clone()
    dev = a.device
    rp = torch.arange(m, device=dev)
    cp = torch.arange(n, device=dev)
    for j in range(kend):
        flat = a[j:, j:].abs().argmax().reshape(1)
        jt = torch.full((1,), j, dtype=torch.long, device=dev)
        pi, pj = jt + flat // (n - j), jt + flat % (n - j)
        rows, rows_sw = torch.cat([jt, pi]), torch.cat([pi, jt])
        a.index_copy_(0, rows, a.index_select(0, rows_sw))
        rp.index_copy_(0, rows, rp.index_select(0, rows_sw))
        cols, cols_sw = torch.cat([jt, pj]), torch.cat([pj, jt])
        a.index_copy_(1, cols, a.index_select(1, cols_sw))
        cp.index_copy_(0, cols, cp.index_select(0, cols_sw))
        piv = a[j, j]
        l = a[j + 1:, j] / torch.where(piv == 0, 1, piv)
        a[j + 1:, j] = l
        a[j + 1:, j + 1:] -= torch.outer(l, a[j, j + 1:])
    LU_ = redistribute(DistMatrix(a, (m, n), STAR, STAR, 0, 0, g), MC, MR)
    return LU_, rp, cp
