"""Dense LDL^T / LDL^H with Bunch-Kaufman pivoting + symmetric solves.

PyTorch port of ``elemental_tpu/lapack/ldl.py`` (Elemental
``src/lapack_like/factor/LDL.cpp`` + ``LDL/dense/{Var3,Pivoted}.hpp``,
Bunch-Kaufman A, and ``src/lapack_like/solve/``: ``El::SymmetricSolve`` /
``HermitianSolve``).

A LAPACK ``lasyf``-style left-looking panel: :func:`_panel_ldl` factors
columns [s, e) of the symmetric matrix.  Every column it touches -- the
pivot column AND a 2x2 candidate's partner column, which may lie outside
the panel -- is read as ``snapshot column - L W^H correction`` from the
panel-start storage.  The JAX package runs the column loop as one jitted
``fori_loop`` with ``lax.cond`` branches.  Here the loop body,
:func:`_ldl_column`, keeps the column index, the pivot choice and the
skip flag (the second column of a 2x2 pivot) on the device and computes
the 1x1 and 2x2 branches both, selecting with ``torch.where``; a skipped
column writes into spare slots.  So every column runs the same launches
on tensors of fixed shapes: on the card the panel captures one column as
a CUDA graph and replays it, on the CPU it runs eagerly.

On a 1x1 grid the storage IS the global matrix, and the factorization
works in place on one copy of it: a panel's symmetric interchange moves
only the rows and columns its permutation displaces (at most 2 nb), and
the trailing update ``A22 -= L2 W2^H`` is one ``addmm_``.  It updates
both triangles, so later panels' snapshots stay valid.  On a larger grid
the interchange is a storage-level gather and the update one storage
product, as in the JAX package.

For LDL^H each corrected column's diagonal entry is made real before it
is used, as LAPACK's zlahef does.  The JAX package keeps the rounding of
its imaginary part, which enters D's 2x2 inverses and grows from block to
block: its Hermitian reconstruction error is 5.5e-10 at n = 64, nb = 16
(complex128), where the port's is ~1e-15; at the JAX tests' n = 16 the
two agree to 1e-15.

Documented deviation from LAPACK sytrf (the JAX package's): a 2x2 pivot
never CROSSES a panel boundary -- on the last panel column the better of
the two 1x1 choices (|a_kk| vs the partner's |a_rr|) is taken instead;
``nb >= n`` gives LAPACK-faithful pivot sequences.

Packing: ``ldl`` returns ``(Lp, d, e, perm)``: unit-lower L in Lp's
strictly-lower triangle (D's diagonal on Lp's diagonal), D's diagonal in
``d`` and subdiagonal in ``e`` (``e[j] != 0`` marks a 2x2 block at
(j, j+1)), and the row permutation ``perm``: ``(P A P^T) = L D L^H`` with
``(P A P^T)[i, j] = A[perm[i], perm[j]]``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dist import MC, MR, STAR, VR
from ..core.distmatrix import DistMatrix
from ..core.environment import check_precision
from ..core.view import view, update_view
from ..redist.engine import redistribute
from ..blas.level1 import make_symmetric
from ..blas.level3 import _check_mcmr, trsm
from ..tune.policy import blocksize_policy as _blocksize
from .lu import permute_rows, _update_cols_lt

_ALPHA = (1.0 + math.sqrt(17.0)) / 8.0


def _real_dtype(dtype):
    return torch.empty((), dtype=dtype).real.dtype


def _swap(x, pq, qp):
    """Swap entries (rows) p and q of ``x`` in place; ``pq`` = [p, q],
    ``qp`` = [q, p] (p == q is a no-op)."""
    x.index_copy_(0, pq, x.index_select(0, qp))


def _ldl_column(st):
    """One Bunch-Kaufman column of the panel (the JAX package's loop body),
    in place on the panel state ``st``; advances the column index."""
    stor, L, W, d, e = st["stor"], st["L"], st["W"], st["d"], st["e"]
    perm, skip, k, ridx = st["perm"], st["skip"], st["k"], st["ridx"]
    nbw, mt, conj = st["nbw"], st["mt"], st["conj"]
    Lc, Wc = L[:, :nbw], W[:, :nbw]          # the spare column stays out
    srow = st["rowmap"].index_select(0, perm) * st["ld"]
    wmask = st["kidx"] < k

    def col(c):
        """Corrected column ``c`` (a one-element index) of the permuted
        trailing matrix: snapshot - L W[c]^H.  For LDL^H its diagonal entry
        is made real, as LAPACK's zlahef does: left complex, the rounding
        of its imaginary part enters D's 2x2 inverses and grows from block
        to block."""
        g = perm.index_select(0, c) + st["s"]
        base = stor.take(srow + st["colmap"].index_select(0, g))
        wrow = Wc.index_select(0, c)[0]
        wrow = torch.where(wmask, wrow.conj() if conj else wrow, 0)
        w = torch.addmv(base, Lc, wrow, alpha=-1)
        if conj:
            w = torch.where(ridx == c, w.real.to(w.dtype), w)
        return w

    active = ~skip
    wk = col(k)
    awk = wk.abs()
    absakk = awk.index_select(0, k)
    tail = torch.where(ridx > k, awk, -1.0)
    imax = tail.argmax().reshape(1)
    colmax = tail.index_select(0, imax).clamp_min(0.0)
    wr = col(imax)
    awr = wr.abs()
    rowtail = torch.where((ridx >= k) & (ridx != imax), awr, -1.0)
    rowmax = rowtail.max().clamp_min(st["tiny"])
    absarr = awr.index_select(0, imax)
    t11 = (colmax <= 0) | (absakk >= _ALPHA * colmax * (colmax / rowmax))
    t11s = ~t11 & (absarr >= _ALPHA * rowmax)
    last = k == nbw - 1
    t22 = ~t11 & ~t11s & ~last
    # boundary fallback: the better 1x1 (swap iff the partner is larger)
    t11s = t11s | (~t11 & last & (absarr > absakk))
    k1 = (k + 1).clamp_max(mt - 1)
    # the one row interchange: (k1, imax) for 2x2, (k, imax | k) for 1x1,
    # none for a skipped column
    p = torch.where(active & t22, k1, k)
    q = torch.where(active & (t22 | t11s), imax, k)
    pq, qp = torch.cat([p, q]), torch.cat([q, p])
    for x in (perm, L, W, wk, wr):
        _swap(x, pq, qp)
    w1, w2 = wk, wr
    # 1x1: w is the pivot column (w2 if the partner was swapped in); 2x2:
    # w = w1 too (t22 excludes t11s), so W's column k and d[k] share one
    # formula
    w = torch.where(t11s, w2, w1)
    dk = w.index_select(0, k)
    dk_safe = torch.where(dk == 0, 1, dk)
    d11, d21 = dk, w1.index_select(0, k1)
    d22 = w2.index_select(0, k1)
    off = d21.conj() if conj else d21
    det = d11 * d22 - d21 * off
    det = torch.where(det == 0, 1, det)
    i11, i12 = d22 / det, -off / det
    i21, i22 = -d21 / det, d11 / det
    below = torch.where(t22, k1, k)
    lk = torch.where(t22, w1 * i11 + w2 * i21, w / dk_safe)
    lk = torch.where(ridx > below, lk, 0)
    lk = torch.where(ridx == k, 1, lk)
    l2 = torch.where(ridx > k1, w1 * i12 + w2 * i22, 0)
    l2 = torch.where(ridx == k1, 1, l2)
    upper = ridx >= k
    wk_col = torch.where(upper, w, 0)
    w2_col = torch.where(upper, w2, 0)
    # skipped writes land in the spare slot nbw
    spare = torch.full_like(k, nbw)
    kk = torch.where(active, k, spare)
    do22 = active & t22
    k2 = torch.where(do22, k + 1, spare)
    ke = torch.where(do22, k, spare)
    cols = torch.cat([kk, k2])
    L.index_copy_(1, cols, torch.stack([lk, l2], 1))
    W.index_copy_(1, cols, torch.stack([wk_col, w2_col], 1))
    dvals = torch.cat([dk, d22])
    d.index_copy_(0, cols, dvals.real if conj else dvals)
    e.index_copy_(0, ke, d21)
    skip.copy_(do22)
    k += 1


def _panel_ldl(stor, s: int, m: int, nbw: int, conjugate: bool,
               Sc: int, Sr: int):
    """Bunch-Kaufman panel over global rows/cols [s, m) x [s, s+nbw).

    ``stor`` is the full SYMMETRIC stacked-storage array (the panel-start
    snapshot; on a 1x1 grid the working matrix itself, which the panel
    only reads).  Returns (L, W, d, e, perm): L unit-lower (mt, nbw) and
    W = L D, both with rows in the PERMUTED order; perm maps output panel
    row i -> input panel row perm[i].

    Every column runs the same launches on tensors of fixed shapes, with
    its index on the device: on the card the first column runs eagerly
    and the rest replay one CUDA graph of it."""
    mt = m - s
    dtype = stor.dtype
    dev = stor.device
    rdtype = _real_dtype(dtype) if conjugate else dtype
    stor = stor.contiguous()
    lr, lc = -(-m // Sc), -(-m // Sr)
    grow = torch.arange(s, m, device=dev)
    gcol = torch.arange(m, device=dev)
    st = {
        "stor": stor.reshape(-1), "ld": stor.shape[1], "s": s,
        "rowmap": (grow % Sc) * lr + grow // Sc,
        "colmap": (gcol % Sr) * lc + gcol // Sr,
        "L": torch.zeros((mt, nbw + 1), dtype=dtype, device=dev),
        "W": torch.zeros((mt, nbw + 1), dtype=dtype, device=dev),
        "d": torch.zeros((nbw + 1,), dtype=rdtype, device=dev),
        "e": torch.zeros((nbw + 1,), dtype=dtype, device=dev),
        "perm": torch.arange(mt, device=dev),
        "skip": torch.zeros((1,), dtype=torch.bool, device=dev),
        "k": torch.zeros((1,), dtype=torch.long, device=dev),
        "ridx": torch.arange(mt, device=dev),
        "kidx": torch.arange(nbw, device=dev),
        "nbw": nbw, "mt": mt, "conj": conjugate,
        "tiny": torch.finfo(_real_dtype(dtype)).tiny,
    }
    if not stor.is_cuda:
        for _ in range(nbw):
            _ldl_column(st)
    else:
        # column 0 on a side stream is the warm-up that graph capture needs
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _ldl_column(st)
        torch.cuda.current_stream(dev).wait_stream(side)
        if nbw > 1:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                _ldl_column(st)
            for _ in range(nbw - 1):
                graph.replay()
            del graph
    return (st["L"][:, :nbw], st["W"][:, :nbw], st["d"][:nbw],
            st["e"][:nbw], st["perm"])


def _apply_sym_perm(A: DistMatrix, s: int, pperm) -> DistMatrix:
    """Symmetrically permute global rows AND cols [s, m) by ``pperm`` on the
    stacked storage (two gathers)."""
    m, n = A.gshape
    Sc, Sr = A.col_stride, A.row_stride
    lr, lc = A.local_rows, A.local_cols
    dev = A.local.device
    stor = A.local.clone()
    grow = s + pperm
    gdst = torch.arange(s, m, device=dev)
    srow_dst = (gdst % Sc) * lr + gdst // Sc
    srow_src = (grow % Sc) * lr + grow // Sc
    stor[srow_dst] = stor.index_select(0, srow_src)
    scol_dst = (gdst % Sr) * lc + gdst // Sr
    scol_src = (grow % Sr) * lc + grow // Sr
    stor[:, scol_dst] = stor.index_select(1, scol_src)
    return A.with_local(stor)


def _displaced(pperm, nbw: int):
    """Indices (into the trailing block) of the rows the composed panel
    permutation moves, first, padded to ``min(2 nbw, M)`` with rows it
    leaves in place (each then copied onto itself), and their sources:
    a composition of nbw swaps moves at most 2 nbw rows."""
    M = pperm.shape[0]
    moved = pperm != torch.arange(M, device=pperm.device)
    idx = torch.argsort((~moved).to(torch.int8), stable=True)[:min(2 * nbw, M)]
    return idx, pperm.index_select(0, idx)


def _local_ldl(full: DistMatrix, ib: int, conjugate: bool):
    """The 1x1-grid path: the blocked loop in place on one copy of the
    symmetric matrix."""
    m = full.gshape[0]
    a = full.local.clone(memory_format=torch.contiguous_format)
    gperm = torch.arange(m, device=a.device)
    d_parts, e_parts = [], []
    for s in range(0, m, ib):
        e_col = min(s + ib, m)
        nbw = e_col - s
        L, W, dpan, epan, pperm = _panel_ldl(a, s, m, nbw, conjugate, 1, 1)
        d_parts.append(dpan)
        e_parts.append(epan)
        gperm[s:] = gperm[s:].index_select(0, pperm)
        idx, src = _displaced(pperm, nbw)
        a.index_copy_(0, idx + s, a.index_select(0, src + s))
        a.index_copy_(1, idx + s, a.index_select(1, src + s))
        # the packed panel: L below the diagonal, D's diagonal on it
        blk = a[s:, s:e_col]
        blk.copy_(torch.tril(L, -1))
        blk.diagonal().copy_(dpan)
        if e_col < m:
            # A22 -= L2 W2^H over both triangles
            W2 = W[nbw:]
            a[e_col:, e_col:].addmm_(L[nbw:], W2.mH if conjugate else W2.mT,
                                     alpha=-1)
    return full.with_local(a), d_parts, e_parts, gperm


def ldl(A: DistMatrix, uplo: str = "L", conjugate: bool | None = None,
        nb: int | None = None, precision=None):
    """Pivoted LDL factorization of a symmetric/Hermitian [MC,MR] matrix
    (``El::LDL`` with Bunch-Kaufman-A pivoting).  Reads the ``uplo``
    triangle; ``conjugate`` selects LDL^H (default for complex input) vs
    LDL^T.  Returns ``(Lp, d, e, perm)`` (see the module docstring);
    ``d``, ``e`` and ``perm`` are tensors on the grid's device."""
    _check_mcmr(A)
    check_precision(precision, A.local)
    m = A.gshape[0]
    if A.gshape != (m, m):
        raise ValueError(f"ldl needs square, got {A.gshape}")
    if conjugate is None:
        conjugate = A.dtype.is_complex
    g = A.grid
    r, c = g.height, g.width
    full = make_symmetric(A, uplo, conj=conjugate)
    ib = _blocksize(nb, math.lcm(r, c), m)
    if g.size == 1:
        full, d_parts, e_parts, gperm = _local_ldl(full, ib, conjugate)
    else:
        full, d_parts, e_parts, gperm = _dist_ldl(full, ib, conjugate)
    d = torch.cat(d_parts)
    # the subdiagonal has length m-1 (a panel boundary never hosts a 2x2)
    e_ = torch.cat(e_parts)[:max(m - 1, 0)]
    return full, d, e_, gperm


def _dist_ldl(full: DistMatrix, ib: int, conjugate: bool):
    """The r x c path, on storage: the JAX package's loop."""
    m = full.gshape[0]
    g = full.grid
    c = g.width
    Sc, Sr = full.col_stride, full.row_stride
    d_parts, e_parts = [], []
    gperm = torch.arange(m, device=full.local.device)
    for s in range(0, m, ib):
        e_col = min(s + ib, m)
        nbw = e_col - s
        L, W, dpan, epan, pperm = _panel_ldl(full.local, s, m, nbw,
                                             conjugate, Sc, Sr)
        d_parts.append(dpan)
        e_parts.append(epan)
        gperm[s:] = gperm[s:].index_select(0, pperm)
        full = _apply_sym_perm(full, s, pperm)
        packed = torch.tril(L, -1)
        packed.diagonal().copy_(dpan)
        blk = DistMatrix(packed, (m - s, nbw), STAR, STAR, 0, 0, g)
        e_up = min(-(-e_col // c) * c, m)
        if e_up > e_col:
            wpad = torch.nn.functional.pad(packed, (0, e_up - e_col))
            blk = DistMatrix(wpad, (m - s, e_up - s), STAR, STAR, 0, 0, g)
        full = _update_cols_lt(full, redistribute(blk, MC, MR),
                               (s, m), (s, e_up), e_col)
        if e_col == m:
            break
        # trailing update A22 -= L2 W2^H over both triangles, so that later
        # panels' snapshots stay valid
        nt = m - e_col
        L2 = L[nbw:, :]
        W2 = W[nbw:, :]
        W2H = W2.mH if conjugate else W2.mT
        L2_mc = redistribute(DistMatrix(L2, (nt, nbw), STAR, STAR, 0, 0, g),
                             MC, STAR)
        W2H_mr = redistribute(DistMatrix(W2H, (nbw, nt), STAR, STAR, 0, 0, g),
                              STAR, MR)
        A22 = view(full, rows=(e_col, m), cols=(e_col, m))
        upd = L2_mc.local @ W2H_mr.local
        full = update_view(full, A22.with_local(A22.local - upd),
                           rows=(e_col, m), cols=(e_col, m))
    return full, d_parts, e_parts, gperm


def _block_diag_solve(d, e, Y: DistMatrix, conjugate: bool) -> DistMatrix:
    """X = D^{-1} Y for the Bunch-Kaufman block-diagonal D (replicated d/e;
    rows paired on [STAR,VR], where they are local)."""
    m = Y.gshape[0]
    Yvr = redistribute(Y, STAR, VR)
    y = Yvr.local
    dtype = y.dtype
    dev = y.device
    dd = d.to(dtype)
    zero1 = torch.zeros((1,), dtype=dtype, device=dev)
    one1 = torch.ones((1,), dtype=dtype, device=dev)
    ee = torch.cat([e.to(dtype), zero1]) if e.shape[0] == m - 1 \
        else e.to(dtype)

    def _c(x):
        return x.conj() if conjugate else x

    start2 = ee != 0                                # j starts a 2x2 block
    second2 = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev),
                         start2[:-1]])
    # candidate 2x2 solutions for every j (used only where start2/second2)
    a = dd
    b = ee
    cdiag = torch.cat([dd[1:], one1])
    det = a * cdiag - b * _c(b)
    det = torch.where(det == 0, 1, det)
    yz = torch.zeros((1,) + tuple(y.shape[1:]), dtype=dtype, device=dev)
    y2 = torch.cat([y[1:], yz])
    x_start = (cdiag[:, None] * y - _c(b)[:, None] * y2) / det[:, None]
    y1m = torch.cat([yz, y[:-1]])
    a_m = torch.cat([one1, a[:-1]])
    b_m = torch.cat([one1, b[:-1]])
    det_m = torch.cat([one1, det[:-1]])
    x_second = (a_m[:, None] * y - b_m[:, None] * y1m) / det_m[:, None]
    d_safe = torch.where(dd == 0, 1, dd)
    x_single = y / d_safe[:, None]
    x = torch.where(start2[:, None], x_start,
                    torch.where(second2[:, None], x_second, x_single))
    return redistribute(Yvr.with_local(x), MC, MR)


def ldl_solve_after(Lp: DistMatrix, d, e, perm, B: DistMatrix,
                    conjugate: bool = True, nb: int | None = None,
                    precision=None) -> DistMatrix:
    """X = A^{-1} B from an ``ldl`` factorization (``ldl::SolveAfter``):
    P^T L D L^H P X = B."""
    orient = "C" if conjugate else "T"
    Bp = permute_rows(B, perm)
    Y = trsm("L", "L", "N", Lp, Bp, unit=True, nb=nb, precision=precision)
    Z = _block_diag_solve(d, e, Y, conjugate)
    X = trsm("L", "L", orient, Lp, Z, unit=True, nb=nb, precision=precision)
    return permute_rows(X, perm, inverse=True)


def symmetric_solve(A: DistMatrix, B: DistMatrix, uplo: str = "L",
                    nb: int | None = None, precision=None) -> DistMatrix:
    """Solve A X = B for symmetric A via pivoted LDL^T
    (``El::SymmetricSolve``)."""
    Lp, d, e, perm = ldl(A, uplo, conjugate=False, nb=nb, precision=precision)
    return ldl_solve_after(Lp, d, e, perm, B, conjugate=False, nb=nb,
                           precision=precision)


def hermitian_solve(A: DistMatrix, B: DistMatrix, uplo: str = "L",
                    nb: int | None = None, precision=None) -> DistMatrix:
    """Solve A X = B for Hermitian A via pivoted LDL^H
    (``El::HermitianSolve``)."""
    Lp, d, e, perm = ldl(A, uplo, conjugate=True, nb=nb, precision=precision)
    return ldl_solve_after(Lp, d, e, perm, B, conjugate=True, nb=nb,
                           precision=precision)


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def inertia(d, e):
    """(num positive, num negative, num zero) eigenvalue counts from the
    Bunch-Kaufman D (``El::Inertia``; Sylvester's law of inertia).

    Each 2x2 block contributes one positive and one negative eigenvalue
    (Bunch-Kaufman 2x2 pivots are always indefinite)."""
    dn = _host(d)
    en = _host(e)
    m = dn.shape[0]
    en = np.concatenate([en, np.zeros(1, en.dtype)]) if en.shape[0] == m - 1 \
        else en
    start2 = en != 0
    second2 = np.concatenate([[False], start2[:-1]])
    single = ~(start2 | second2)
    npos = int(np.sum(np.real(dn[single]) > 0)) + int(np.sum(start2))
    nneg = int(np.sum(np.real(dn[single]) < 0)) + int(np.sum(start2))
    nzero = int(np.sum(np.real(dn[single]) == 0))
    return npos, nneg, nzero
