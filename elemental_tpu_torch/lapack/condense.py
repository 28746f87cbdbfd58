"""Condense layer: reduction to tridiagonal, bidiagonal and Hessenberg form.

PyTorch port of ``elemental_tpu/lapack/condense.py`` (``_real_dtype``,
``_larfg_at``, ``_tridiag_panel``, ``_packed_panel``,
``hermitian_tridiag``, ``_tridiag_v_panel``, ``apply_q_herm_tridiag``,
``_bidiag_panel``, ``bidiag``, ``apply_p_bidiag``, ``hessenberg`` and
``apply_q_hessenberg``; Elemental
``src/lapack_like/condense/HermitianTridiag/**``: blocked latrd panels
building a W panel from one Hemv a column, then a Her2k-style two-sided
trailing update; ``Bidiag/**``; ``Hessenberg/**``).

The JAX package runs each panel's column loop as one jitted
``fori_loop``.  Here the loop body, :func:`_tridiag_column`, keeps the
column index on the device, so no launch waits for the host and every
column runs the same launches on tensors of fixed shapes: on the card
the panel captures one column as a CUDA graph and replays it, on the CPU
it runs eagerly.  The replicated vectors need no [MC,MR] wrapping around
the Hemv.  What the loop's Hemv reads is fixed for the whole panel, so
:func:`_hemv_operand` forms the Hermitian trailing matrix from its stored
lower triangle ONCE a panel and each column does one matrix-vector pass
over it (the JAX ``hemv`` builds two masked copies and does two passes
each column).  The trailing update ``A22 -= V W^H + W V^H`` is two
storage matmuls, masked to the lower triangle.

Packing (lower): reflector j has an implicit 1 at row j+1; its tail lives
in ``Ap[j+2:, j]``; ``d``/``e`` (real) are returned separately and also
written to the diagonal/subdiagonal of ``Ap``.  ``uplo`` selects which
triangle of the Hermitian input is read; the packing is always lower.

``bidiag`` is blocked the same way (labrd panels, a rank-2k trailing
update); its column loop runs eagerly on the card, with the pivot index
on the device.  ``hessenberg`` is the JAX package's unblocked replicated
reduction.  Every apply function rebuilds a panel's T with the blocked
:func:`~..kernels.qr_panel._larft`.
"""
from __future__ import annotations

import math

import torch

from ..core.dist import MC, MR, STAR
from ..core.distmatrix import DistMatrix
from ..core.environment import check_precision
from ..core.view import view, update_view, round_up
from ..redist.engine import redistribute, transpose_dist
from ..blas.level1 import _global_indices
from ..blas.level3 import _check_mcmr, _mask_triangle
from ..kernels.qr_panel import _larft
from ..tune.policy import blocksize_policy as _blocksize
from .lu import _update_cols_lt


def _real_dtype(dtype):
    return torch.empty((), dtype=dtype).real.dtype


def _larfg_at(col, piv, ridx):
    """Householder reflector pivoting at row ``piv`` (zeroes rows > piv):
    real beta, H = I - tau v v^H, implicit v[piv] = 1.  ``piv`` is a
    one-element index tensor on ``col``'s device, so nothing waits for the
    device and the same launches serve every column.  Returns ``(v, tau,
    beta)``, ``tau`` and ``beta`` of shape (1,)."""
    alpha = col.index_select(0, piv)
    anorm = torch.linalg.vector_norm(torch.where(ridx >= piv, col, 0))
    # -sign(re(alpha), with 0 counted positive) * anorm
    beta = -torch.copysign(anorm, alpha.real + 0.0)
    degenerate = anorm == 0
    safe_beta = torch.where(degenerate, 1.0, beta)
    tau = torch.where(degenerate, 0.0, (safe_beta - alpha) / safe_beta)
    denom = alpha - safe_beta
    safe_denom = torch.where(denom == 0, 1.0, denom)
    v = torch.where(ridx > piv, col / safe_denom, 0)
    v = torch.where(ridx == piv, 1.0, v)
    return v.to(col.dtype), tau.to(col.dtype), beta


def _hemv_operand(Atrail: DistMatrix):
    """The full Hermitian (nt, nt) matrix whose lower triangle ``Atrail``
    stores, as one replicated tensor: what every column's Hemv of a panel
    reads (the upper triangle of ``Atrail`` is stale and never read)."""
    Ag = redistribute(Atrail, STAR, STAR).local
    return torch.tril(Ag) + torch.tril(Ag, -1).mH


def _corrected_col(P, Xt, jj):
    """Column ``jj`` (a one-element index tensor) of the running matrix
    ``A0 - V W^H - W V^H``, with ``Xt = [V | W]^T``."""
    nbw = Xt.shape[0] // 2
    col = P.index_select(1, jj)[:, 0]
    # [conj W[jj]; conj V[jj]]: one product for both corrections
    c = Xt.index_select(1, jj)[:, 0].roll(nbw).conj()
    return col.addmv_(Xt.mT, c, alpha=-1)


def _tridiag_column(H, P, Xt, d, e, tau, jj, ridx):
    """One column of latrd (the JAX package's loop body), in place on the
    panel state ``Xt = [V | W]^T, d, e, tau``; advances the column index
    ``jj``."""
    nbw = Xt.shape[0] // 2
    col = _corrected_col(P, Xt, jj)
    d.index_copy_(0, jj, col.index_select(0, jj).real)
    v, tau_j, beta = _larfg_at(col, jj + 1, ridx)
    e.index_copy_(0, jj, beta)
    # the one distributed product per column: u = A_trail v (Hemv; v's
    # leading zeros make this the reference's A22 v on the true subproblem)
    u = H @ v
    # u -= V (W^H v) + W (V^H v): [V^H v; W^H v] in one product
    y = (Xt @ v.conj()).conj()
    u.addmv_(Xt.mT, y.roll(nbw), alpha=-1)
    w = torch.where(ridx > jj, tau_j * u, 0)
    w -= (0.5 * tau_j * torch.vdot(w, v)) * v
    Xt.view(2, nbw, -1).index_copy_(1, jj, torch.stack([v, w])[:, None])
    tau.index_copy_(0, jj, tau_j)
    jj += 1


def _tridiag_panel(H, P, nbw: int, extract_last: bool):
    """latrd: reduce ``nbw`` columns of the trailing matrix.

    ``H`` is :func:`_hemv_operand` of the fixed (nt, nt) trailing view and
    ``P`` the replicated panel columns.  Returns (V, W, d, e, tau) with
    V/W the (nt, nbw) replicated reflector/update panels (views of one
    ``[V | W]^T`` buffer, so each correction is one product and both
    products with it read contiguous rows).

    Every column runs the same launches on tensors of fixed shapes, with
    the column index on the device: on the card the first column runs
    eagerly and the rest replay one CUDA graph of it, so the host's cost
    is one graph launch a column rather than ~45 kernel launches."""
    nt = H.shape[0]
    dtype = P.dtype
    rdtype = _real_dtype(dtype)
    dev = P.device
    nd = nbw + 1 if extract_last else nbw
    Xt = torch.zeros((2 * nbw, nt), dtype=dtype, device=dev)
    d = torch.zeros((nd,), dtype=rdtype, device=dev)
    e = torch.zeros((nbw,), dtype=rdtype, device=dev)
    tau = torch.zeros((nbw,), dtype=dtype, device=dev)
    jj = torch.zeros((1,), dtype=torch.long, device=dev)
    ridx = torch.arange(nt, device=dev)

    def column():
        _tridiag_column(H, P, Xt, d, e, tau, jj, ridx)

    if not H.is_cuda:
        for _ in range(nbw):
            column()
    else:
        # column 0 on a side stream is the warm-up that graph capture needs
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            column()
        torch.cuda.current_stream(dev).wait_stream(side)
        if nbw > 1:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                column()
            for _ in range(nbw - 1):
                graph.replay()
            del graph
    if extract_last:
        d[nbw] = _corrected_col(P, Xt, jj)[nbw].real
    return Xt[:nbw].mT, Xt[nbw:].mT, d, e, tau


def _packed_panel(V, d, e, nbw: int, dtype):
    """Assemble the packed panel: diag d, subdiag e, reflector tails below."""
    packed = torch.tril(V[:, :nbw], -2)
    idx = torch.arange(nbw, device=V.device)
    packed[idx, idx] = d[:nbw].to(dtype)
    packed[idx + 1, idx] = e[:nbw].to(dtype)
    return packed


def hermitian_tridiag(A: DistMatrix, uplo: str = "L", nb: int | None = None,
                      precision=None):
    """Reduce a Hermitian [MC,MR] matrix to real tridiagonal form.

    Returns ``(Ap, d, e, tau)``: ``A = Q T Q^H`` with ``T = tridiag(e, d, e)``
    and ``Q = H_0 H_1 ... H_{n-2}`` packed in ``Ap``'s lower triangle
    (``El::HermitianTridiag``).  ``precision`` is ``None`` or ``'highest'``
    (full float32/float64 arithmetic)."""
    _check_mcmr(A)
    check_precision(precision, A.local)
    n = A.gshape[0]
    if A.gshape != (n, n):
        raise ValueError(f"hermitian_tridiag needs square, got {A.gshape}")
    if uplo.upper().startswith("U"):
        A = redistribute(transpose_dist(A, conj=True), MC, MR)
    g = A.grid
    r, c = g.height, g.width
    dtype = A.dtype
    rdtype = _real_dtype(dtype)
    dev = A.local.device
    if n == 0:
        z = torch.zeros((0,), dtype=rdtype, device=dev)
        return A, z, z, torch.zeros((0,), dtype=dtype, device=dev)
    if n == 1:
        dd = redistribute(A, STAR, STAR).local[0, 0].real[None].to(rdtype)
        return (A, dd, torch.zeros((0,), dtype=rdtype, device=dev),
                torch.zeros((0,), dtype=dtype, device=dev))

    ib = _blocksize(nb, math.lcm(r, c), n)
    kend = n - 1                          # reflector columns 0 .. n-2
    Ap = A
    d_parts, e_parts, tau_parts = [], [], []
    s = 0
    while s < kend:
        e_col = min(s + ib, kend)
        nbw = e_col - s
        final = e_col == kend
        wp_end = n if final else min(round_up(e_col, c), n)
        H = _hemv_operand(view(Ap, rows=(s, n), cols=(s, n)))
        P = redistribute(view(Ap, rows=(s, n), cols=(s, wp_end)),
                         STAR, STAR).local
        V, W, dpan, epan, taupan = _tridiag_panel(H, P, nbw, final)
        del H
        d_parts.append(dpan)
        e_parts.append(epan)
        tau_parts.append(taupan)
        packed = _packed_panel(V, dpan, epan, nbw, dtype)
        if final:
            # last column: its diagonal entry
            nt = n - s
            last = torch.zeros((nt, 1), dtype=dtype, device=dev)
            last[nt - 1, 0] = dpan[nbw]
            packed = torch.cat([packed, last], dim=1)
            blk = DistMatrix(packed, (nt, nt), STAR, STAR, 0, 0, g)
            Ap = _update_cols_lt(Ap, redistribute(blk, MC, MR), (s, n),
                                 (s, n), n)
            break
        wpad = wp_end - s - nbw
        if wpad:
            packed = torch.nn.functional.pad(packed, (0, wpad))
        blk = DistMatrix(packed, (n - s, wp_end - s), STAR, STAR, 0, 0, g)
        Ap = _update_cols_lt(Ap, redistribute(blk, MC, MR), (s, n),
                             (s, wp_end), e_col)
        # trailing two-sided update: A22 -= V2 W2^H + W2 V2^H (lower triangle)
        nt2 = n - e_col
        V2 = V[e_col - s:, :]
        W2 = W[e_col - s:, :]
        V2mc = redistribute(DistMatrix(V2, (nt2, nbw), STAR, STAR, 0, 0, g),
                            MC, STAR)
        W2mc = redistribute(DistMatrix(W2, (nt2, nbw), STAR, STAR, 0, 0, g),
                            MC, STAR)
        V2Hmr = redistribute(DistMatrix(V2.mH, (nbw, nt2), STAR, STAR, 0, 0, g),
                             STAR, MR)
        W2Hmr = redistribute(DistMatrix(W2.mH, (nbw, nt2), STAR, STAR, 0, 0, g),
                             STAR, MR)
        A22 = view(Ap, rows=(e_col, n), cols=(e_col, n))
        upd = torch.addmm(A22.local, V2mc.local, W2Hmr.local, alpha=-1)
        upd.addmm_(W2mc.local, V2Hmr.local, alpha=-1)
        newloc = torch.where(_mask_triangle(A22, "L"), upd, A22.local)
        del upd
        Ap = update_view(Ap, A22.with_local(newloc), rows=(e_col, n),
                         cols=(e_col, n))
        s = e_col
    return Ap, torch.cat(d_parts), torch.cat(e_parts), torch.cat(tau_parts)


def _tridiag_v_panel(P, nbw: int):
    """Unit-structured reflector panel from tridiag packing: V[jj+1,jj]=1,
    tails from rows >= jj+2."""
    V = torch.tril(P[:, :nbw], -2)
    idx = torch.arange(nbw, device=P.device)
    V[idx + 1, idx] = 1
    return V


def apply_q_herm_tridiag(Ap: DistMatrix, tau, B: DistMatrix,
                         orient: str = "N", nb: int | None = None,
                         precision=None) -> DistMatrix:
    """B := Q B ('N') or Q^H B ('C') with Q from :func:`hermitian_tridiag`
    (the back-transform of ``El::HermitianEig``, ``ApplyPackedReflectors``).
    ``nb`` must match the factorization's.

    Each panel's T is rebuilt with :func:`_larft` (blocked, a few
    launches a panel).  On a 1x1 grid the panels update one clone of ``B`` in
    place (``addmm_``), as :func:`~.qr.apply_q` does."""
    _check_mcmr(Ap, B)
    check_precision(precision, Ap.local, B.local)
    n = Ap.gshape[0]
    if B.gshape[0] != n:
        raise ValueError(f"B height {B.gshape[0]} != {n}")
    g = Ap.grid
    r, c = g.height, g.width
    ib = _blocksize(nb, math.lcm(r, c), n)
    kend = n - 1
    starts = list(range(0, kend, ib))
    if orient == "N":
        starts = starts[::-1]
    local = g.size == 1
    if local:
        b = B.local.clone(memory_format=torch.contiguous_format)
    for s in starts:
        e_col = min(s + ib, kend)
        nbw = e_col - s
        wp_end = n if e_col == kend else min(round_up(e_col, c), n)
        if local:
            P = Ap.local[s:, s:wp_end]
        else:
            P = redistribute(view(Ap, rows=(s, n), cols=(s, wp_end)),
                             STAR, STAR).local
        V = _tridiag_v_panel(P, nbw)
        T = _larft(V, tau[s:e_col])
        Tm = T.mH if orient == "C" else T
        if local:
            b[s:].addmm_(V, Tm @ (V.mH @ b[s:]), alpha=-1)
            continue
        V_mc = redistribute(
            DistMatrix(V, (n - s, nbw), STAR, STAR, 0, 0, g), MC, STAR)
        B2 = view(B, rows=(s, n))
        Wl = Tm @ (V_mc.local.mH @ B2.local)
        upd = V_mc.local @ Wl
        B = update_view(B, B2.with_local(B2.local - upd.to(B.dtype)),
                        rows=(s, n))
    return B.with_local(b) if local else B


# ---------------------------------------------------------------------
# Bidiagonal reduction (the SVD condense step)
# ---------------------------------------------------------------------

def _bidiag_panel(Ag, Pc, Pr, nbw: int):
    """labrd: reduce ``nbw`` columns AND rows of the (mt, nt) trailing
    matrix ``Ag`` (replicated, fixed for the panel).

    ``Pc``/``Pr``: the replicated panel columns (mt, nbw) / rows (nbw, nt)
    at panel start.  The running matrix is ``A0 - U Y^H - X V^H``; per
    column the two products with ``Ag`` are the reference's
    ``bidiag::PanelBidiag`` distributed products (one ``gemv^H`` building
    Y, one ``gemv`` building X).  The JAX package runs the loop as one
    jitted ``fori_loop``; here it runs eagerly, with the pivot index as a
    one-element device tensor, so no launch waits for the host."""
    mt, nt = Ag.shape
    dtype = Pc.dtype
    rdtype = _real_dtype(dtype)
    dev = Pc.device
    U = torch.zeros((mt, nbw), dtype=dtype, device=dev)
    Y = torch.zeros((nt, nbw), dtype=dtype, device=dev)
    V = torch.zeros((nt, nbw), dtype=dtype, device=dev)
    X = torch.zeros((mt, nbw), dtype=dtype, device=dev)
    d = torch.zeros((nbw,), dtype=rdtype, device=dev)
    e = torch.zeros((nbw,), dtype=rdtype, device=dev)
    tauq = torch.zeros((nbw,), dtype=dtype, device=dev)
    taup = torch.zeros((nbw,), dtype=dtype, device=dev)
    ridx = torch.arange(mt, device=dev)
    cidx = torch.arange(nt, device=dev)
    piv = torch.arange(nbw + 1, device=dev)
    for j in range(nbw):
        # current column j
        col = Pc[:, j] - U @ Y[j].conj() - X @ V[j].conj()
        u, tq, beta = _larfg_at(col, piv[j:j + 1], ridx)
        d[j:j + 1] = beta
        # larfg: H^H x = beta e, so the left update A <- H^H A is
        # A - u y^H with y = tq * A_cur^H u
        y = Ag.mH @ u
        y -= Y @ (U.mH @ u) + V @ (X.mH @ u)
        U[:, j] = u
        Y[:, j] = tq * y
        tauq[j:j + 1] = tq
        if j + 1 >= nt:
            continue                     # no right reflector: v, x, tp = 0
        # current row j (after the left update): right reflector at col j+1
        row = Pr[j] - U[j] @ Y.mH - X[j] @ V.mH
        v, tp, betar = _larfg_at(row.conj(), piv[j + 1:j + 2], cidx)
        e[j:j + 1] = betar
        # right update A <- A G with G = I - tp v v^H: x = tp * A_cur v
        x = Ag @ v
        x -= U @ (Y.mH @ v) + X @ (V.mH @ v)
        V[:, j] = v
        X[:, j] = tp * x
        taup[j:j + 1] = tp
    return U, Y, V, X, d, e, tauq, taup


def bidiag(A: DistMatrix, nb: int | None = None, precision=None):
    """Reduce a tall/square [MC,MR] matrix (m >= n) to upper bidiagonal
    form ``A = Q B P^H`` (``El::Bidiag``).

    Returns ``(Ap, d, e, tauq, taup)``: ``d`` the diagonal, ``e`` the
    superdiagonal (length n-1); left reflectors packed below the diagonal
    of ``Ap`` (unit at row j -- geqrf layout, so :func:`.qr.apply_q`
    applies Q); right reflector j's tail stored in ROW j at columns
    >= j+2 (unit at column j+1), applied by :func:`apply_p_bidiag`."""
    _check_mcmr(A)
    check_precision(precision, A.local)
    m, n = A.gshape
    if m < n:
        raise ValueError("bidiag requires m >= n (transpose the input)")
    g = A.grid
    r, c = g.height, g.width
    dtype = A.dtype
    rdtype = _real_dtype(dtype)
    dev = A.local.device
    if n == 0:
        z = torch.zeros((0,), dtype=rdtype, device=dev)
        zt = torch.zeros((0,), dtype=dtype, device=dev)
        return A, z, z, zt, zt
    ib = _blocksize(nb, math.lcm(r, c), n)
    Ap = A
    d_parts, e_parts, tq_parts, tp_parts = [], [], [], []
    for s in range(0, n, ib):
        e_col = min(s + ib, n)
        nbw = e_col - s
        ce_up = min(round_up(e_col, c), n)
        re_up = min(round_up(e_col, r), m)
        Ag = redistribute(view(Ap, rows=(s, m), cols=(s, n)), STAR, STAR).local
        Pc = redistribute(view(Ap, rows=(s, m), cols=(s, ce_up)),
                          STAR, STAR).local[:, :nbw]
        Pr = redistribute(view(Ap, rows=(s, re_up), cols=(s, n)),
                          STAR, STAR).local[:nbw, :]
        U, Y, V, X, dpan, epan, tq, tp = _bidiag_panel(Ag, Pc, Pr, nbw)
        del Ag
        d_parts.append(dpan)
        e_parts.append(epan)
        tq_parts.append(tq)
        tp_parts.append(tp)
        # packed panel columns: u tails below diag, d on diag, e on superdiag
        mt, nt = m - s, n - s
        rl = torch.arange(mt, device=dev)[:, None]
        cl = torch.arange(nbw, device=dev)[None, :]
        packedc = torch.where(rl > cl, U, 0)
        packedc = torch.where(rl == cl, dpan[None, :].to(dtype), packedc)
        esup = torch.cat([torch.zeros((1,), dtype=rdtype, device=dev),
                          epan[:nbw - 1]])
        packedc = torch.where(rl == cl - 1, esup[None, :].to(dtype), packedc)
        # in-panel right-reflector tails: entry (i, jc) with i <= jc-2 holds
        # v_i[jc] (row-stored packing restricted to the panel's columns)
        VT = torch.nn.functional.pad(V.mT[:, :nbw], (0, 0, 0, mt - nbw))
        packedc = torch.where(rl + 2 <= cl, VT, packedc)
        if ce_up > e_col:
            packedc = torch.nn.functional.pad(packedc, (0, ce_up - e_col))
        blk = DistMatrix(packedc, (mt, ce_up - s), STAR, STAR, 0, 0, g)
        Ap = _update_cols_lt(Ap, redistribute(blk, MC, MR), (s, m),
                             (s, ce_up), e_col)
        # packed panel rows: v tails right of superdiag, e on superdiag
        rl2 = torch.arange(nbw, device=dev)[:, None]
        cl2 = torch.arange(nt, device=dev)[None, :]
        packedr = torch.where(cl2 > rl2 + 1, V.mT, 0)
        packedr = torch.where(cl2 == rl2 + 1, epan[:, None].to(dtype), packedr)
        if re_up > e_col:
            packedr = torch.nn.functional.pad(packedr, (0, 0, 0, re_up - e_col))
        blkr = DistMatrix(packedr, (re_up - s, nt), STAR, STAR, 0, 0, g)
        cur = view(Ap, rows=(s, re_up), cols=(s, n))
        I2, J2 = _global_indices(cur)
        # rows < nbw, columns >= e_col only: the diag/superdiag and in-panel
        # tails are owned by the column write above
        keep = (I2 < nbw)[:, None] & (J2 >= (e_col - s))[None, :]
        merged = torch.where(keep, redistribute(blkr, MC, MR).local, cur.local)
        Ap = update_view(Ap, cur.with_local(merged), rows=(s, re_up),
                         cols=(s, n))
        if e_col == n:
            break
        # trailing update: A22 -= U2 Y2^H + X2 V2^H
        mt2, nt2 = m - e_col, n - e_col

        def panel(P, h, dist):
            ss = DistMatrix(P, (h, nbw) if dist is MC else (nbw, h), STAR,
                            STAR, 0, 0, g)
            return redistribute(ss, MC, STAR) if dist is MC \
                else redistribute(ss, STAR, MR)

        U2mc = panel(U[nbw:], mt2, MC)
        X2mc = panel(X[nbw:], mt2, MC)
        Y2Hmr = panel(Y[nbw:].mH, nt2, MR)
        V2Hmr = panel(V[nbw:].mH, nt2, MR)
        A22 = view(Ap, rows=(e_col, m), cols=(e_col, n))
        new = torch.addmm(A22.local, U2mc.local, Y2Hmr.local, alpha=-1)
        new.addmm_(X2mc.local, V2Hmr.local, alpha=-1)
        Ap = update_view(Ap, A22.with_local(new), rows=(e_col, m),
                         cols=(e_col, n))
    d = torch.cat(d_parts)[:n]
    e_ = torch.cat(e_parts)[:n - 1]
    tauq = torch.cat(tq_parts)[:n]
    taup = torch.cat(tp_parts)[:max(n - 1, 0)]
    return Ap, d, e_, tauq, taup


def apply_p_bidiag(Ap: DistMatrix, taup, B: DistMatrix, orient: str = "N",
                   nb: int | None = None, precision=None) -> DistMatrix:
    """B := P B ('N') or P^H B ('C') with P = G_0 G_1 ... G_{n-2} the
    right-reflector product from :func:`bidiag` (G_j = I - taup_j
    v_j v_j^H, v_j unit at position j+1).  On a 1x1 grid the panels
    update one clone of ``B`` in place, as :func:`~.qr.apply_q` does."""
    _check_mcmr(Ap, B)
    check_precision(precision, Ap.local, B.local)
    n = Ap.gshape[1]
    if B.gshape[0] != n:
        raise ValueError(f"B height {B.gshape[0]} != {n}")
    g = Ap.grid
    r, c = g.height, g.width
    ib = _blocksize(nb, math.lcm(r, c), n)
    kend = max(n - 1, 0)
    starts = list(range(0, kend, ib))
    if orient == "N":
        starts = starts[::-1]
    local = g.size == 1
    if local:
        b = B.local.clone(memory_format=torch.contiguous_format)
    for s in starts:
        e_col = min(s + ib, kend)
        nbw = e_col - s
        re_up = min(round_up(e_col, r), Ap.gshape[0])
        Prow = redistribute(view(Ap, rows=(s, re_up), cols=(s, n)),
                            STAR, STAR).local[:nbw, :]
        # V panel: v_j tails from row j at cols >= j+2 (unit at j+1)
        V = torch.tril(Prow.mT, -2)
        idx = torch.arange(nbw, device=V.device)
        V[idx + 1, idx] = 1
        T = _larft(V, taup[s:e_col])
        Tm = T.mH if orient == "C" else T
        if local:
            b[s:].addmm_(V, Tm @ (V.mH @ b[s:]), alpha=-1)
            continue
        V_mc = redistribute(
            DistMatrix(V, (n - s, nbw), STAR, STAR, 0, 0, g), MC, STAR)
        B2 = view(B, rows=(s, n))
        Wl = Tm @ (V_mc.local.mH @ B2.local)
        upd = V_mc.local @ Wl
        B = update_view(B, B2.with_local(B2.local - upd.to(B.dtype)),
                        rows=(s, n))
    return B.with_local(b) if local else B


# ---------------------------------------------------------------------
# Hessenberg reduction (for Schur / pseudospectra)
# ---------------------------------------------------------------------

def hessenberg(A: DistMatrix, nb: int | None = None, precision=None):
    """Reduce A to upper Hessenberg form: A = Q H Q^H (``El::Hessenberg``,
    lower/'L' reflector convention).

    Returns ``(H, Q_packed, tau)``: ``H`` the [MC,MR] Hessenberg matrix,
    ``Q_packed``/``tau`` the reflectors (packed as by
    :func:`hermitian_tridiag`).  Unblocked and replicated, as the JAX
    package's correctness-first version (its ``fori_loop`` runs eagerly
    here)."""
    _check_mcmr(A)
    check_precision(precision, A.local)
    n = A.gshape[0]
    if A.gshape != (n, n):
        raise ValueError(f"hessenberg needs square, got {A.gshape}")
    g = A.grid
    dtype = A.dtype
    dev = A.local.device
    if n <= 2:
        return A, A, torch.zeros((max(n - 1, 0),), dtype=dtype, device=dev)
    Ag = redistribute(A, STAR, STAR).local.clone()
    ridx = torch.arange(n, device=dev)
    Vp = torch.zeros((n, n - 1), dtype=dtype, device=dev)
    tau = torch.zeros((n - 1,), dtype=dtype, device=dev)
    for jj in range(n - 1):
        v, tau_j, _ = _larfg_at(Ag[:, jj], ridx[jj + 1:jj + 2], ridx)
        # A := H^H A H, H = I - tau v v^H
        w = tau_j.conj() * (v.conj() @ Ag)
        Ag -= torch.outer(v, w)
        u = Ag @ (tau_j * v)
        Ag -= torch.outer(u, v.conj())
        Vp[:, jj] = v
        tau[jj:jj + 1] = tau_j
    # zero below the first subdiagonal (numerical dust from the loop)
    Hloc = torch.triu(Ag, -1)
    H = redistribute(DistMatrix(Hloc, (n, n), STAR, STAR, 0, 0, g), MC, MR)
    packed = torch.tril(Vp, -2)
    idx = torch.arange(n - 1, device=dev)
    packed[idx, idx] = Hloc[idx, idx]
    packed[idx + 1, idx] = Hloc[idx + 1, idx]
    Qp = redistribute(DistMatrix(packed, (n, n - 1), STAR, STAR, 0, 0, g),
                      MC, MR)
    return H, Qp, tau


def apply_q_hessenberg(Qp: DistMatrix, tau, B: DistMatrix, orient: str = "N",
                       precision=None) -> DistMatrix:
    """B := Q B / Q^H B with Q from :func:`hessenberg` (packing as
    tridiag)."""
    check_precision(precision, Qp.local, B.local)
    n = B.gshape[0]
    g = B.grid
    P = redistribute(Qp, STAR, STAR).local
    nref = tau.shape[0]
    V = _tridiag_v_panel(
        torch.nn.functional.pad(P, (0, max(0, n - P.shape[1]))), nref)
    T = _larft(V, tau)
    Tm = T.mH if orient == "C" else T
    V_mc = redistribute(DistMatrix(V, (n, nref), STAR, STAR, 0, 0, g),
                        MC, STAR)
    upd = V_mc.local @ (Tm @ (V_mc.local.mH @ B.local))
    return B.with_local(B.local - upd.to(B.dtype))
