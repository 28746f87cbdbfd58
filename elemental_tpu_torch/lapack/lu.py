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

import torch

from ..core.dist import MC, MR, STAR, VC, VR
from ..core.distmatrix import DistMatrix
from ..core.environment import check_precision
from ..core.view import view, update_view
from ..redist.engine import (apply_fault, move_rows, permute_rows_storage,
                             redistribute)
from ..blas.level1 import _global_indices
from ..blas.level3 import _check_mcmr, local_rank_update, trsm
from ..kernels import lu_panel as _kernel_lu_panel
from ..kernels import default_inners, resolve_panel
from ..kernels.lu_panel import _panel_lu, _panel_lu_unb  # noqa: F401
from ..obs.tracer import NULL_HOOK as _NULL_TIMER, phase_hook as _phase_hook
from ..tune.policy import blocksize_policy as _blocksize
from .cholesky import _check_knobs, _not_ported

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


def _check_lu_knobs(nb, lookahead, crossover, panel, update_precision,
                    comm_precision, redist_path, timer, health, abft,
                    r: int) -> str:
    """Refuse the knobs of later slices; return the panel strategy."""
    _check_knobs(nb, lookahead, crossover, comm_precision, redist_path,
                 timer, health, abft)
    if panel == "auto":
        _not_ported("panel", panel, "the tuner ('auto')")
    if panel is None:
        panel = "classic"
    if panel not in ("classic", "calu"):
        raise ValueError(f"lu: unknown panel strategy {panel!r}; "
                         "expected 'classic', 'calu', or 'auto'")
    if panel == "calu" and r > 1:
        _not_ported("panel", panel, "tournament pivoting (CALU)")
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
    look-ahead, disabled classic; 0 never crosses over).  ``panel`` is
    ``'classic'``; ``'calu'`` on a single-row grid is the classic panel
    (the tournament of one slab IS partial pivoting).

    ``panel_impl`` (``None`` | ``'auto'`` | ``'torch'`` | ``'kernel'``)
    selects the panel implementation; ``None`` and ``'auto'`` take the
    CUDA kernel for a real dtype on the card and the plain chunk ladder
    elsewhere.  ``inners`` overrides the ladder
    (:data:`~elemental_tpu_torch.kernels.DEFAULT_INNERS`); the kernel
    chunks at its finest rung.

    ``precision`` and ``update_precision`` are ``None`` or ``'highest'``
    (full float32/float64 arithmetic); on the card
    ``torch.backends.cuda.matmul.allow_tf32`` must be False.  The knobs
    of later slices -- ``'auto'`` for ``nb`` / ``lookahead`` /
    ``crossover`` / ``panel``, ``panel='calu'`` on a grid with r > 1,
    ``comm_precision``, ``redist_path``, ``timer``, ``health``, ``abft``
    -- raise ``NotImplementedError``."""
    _check_mcmr(A)
    g = A.grid
    r, c = g.height, g.width
    _check_lu_knobs(nb, lookahead, crossover, panel, update_precision,
                    comm_precision, redist_path, timer, health, abft, r)
    check_precision(precision, A.local)
    plan = resolve_panel(panel_impl, dtype=A.dtype, device=A.local.device,
                         inners=inners)
    m, n = A.gshape
    tm = _phase_hook("lu", timer)
    if g.size == 1:
        return _local_lu(A, nb, precision, update_precision, lookahead, tm,
                         plan)

    def factor_panel(Ploc, w: int):
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
                              STAR, STAR)
        nxt = factor_panel(panel0.local[:, :min(ib, kend)], min(ib, kend))
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
                               STAR, STAR)
            Pf, pperm = factor_panel(pan.local[:, :nbw], nbw)
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
        A1n = redistribute(view(A, rows=(s, e), cols=(s, n)), STAR, VR)
        U1n = DistMatrix(Li11 @ A1n.local, (nbw, n - s), STAR, VR, 0, 0, g)
        U1n_mr = redistribute(U1n, STAR, MR)
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
                                   update_precision, lookahead, tm, k, plan)
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
            strip_ss = redistribute(stripD, STAR, STAR)
            nxt = factor_panel(strip_ss.local[:, :e2 - e], e2 - e)
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
                               lookahead, tm, k, plan)
            break
    return A, perm


def _lu_tail(A: DistMatrix, perm, e: int, ib: int, precision,
             update_precision, lookahead: bool, tm, k: int, plan=None):
    """Crossover-to-local finish of the (fully updated) trailing block:
    one [STAR,STAR] gather of rows/cols >= e, the sequential blocked
    kernel, one storage-level row permutation of the already-factored
    left columns, and the factored tail written back."""
    m, n = A.gshape
    g = A.grid
    Atail = redistribute(view(A, rows=(e, m), cols=(e, n)), STAR, STAR)
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
    LU + SolveAfter).  ``info=True`` and ``health`` belong to a later
    slice and raise ``NotImplementedError``."""
    if info:
        _not_ported("info", info, "the singularity report")
    LU_, perm = lu(A, nb=nb, precision=precision, panel=panel, health=health)
    return lu_solve_after(LU_, perm, B, nb=nb, precision=precision)


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
