"""Householder QR, compact-WY application, least squares, LQ and RQ.

PyTorch port of ``elemental_tpu/lapack/qr.py`` (Elemental
``src/lapack_like/factor/QR.cpp`` + ``QR/{Householder,PanelHouseholder,
ApplyQ,SolveAfter}.hpp``, ``reflect/ApplyPacked`` and
``euclidean_min/LeastSquares.cpp``), classic panel.

The panel is gathered to [STAR,STAR] and reduced once (replicated), and
the trailing columns get the compact-WY update ``A2 -= V T^H (V^H A2)``
as storage matmuls, the reference's [MC,STAR] x [STAR,MR] update.  Every
panel goes through :func:`_panel_qr_dispatch`: on a CUDA tensor with a
real dtype it runs the hand-written kernel (``kernels/csrc/
qr_panel.cu``), which returns T with the panel; elsewhere the plain
larfg recurrence, with T from :func:`_larft`.

On a 1x1 grid the storage IS the global matrix, so :func:`qr` works in
place on ONE clone of its input and writes only the entries the JAX
loop's blend keeps: the panel's columns, then the trailing columns >= e
with ``addmm_`` (no temporary of the trailing block).  :func:`apply_q`
does the same on one clone of ``B``.  No driver changes its inputs.

Packing follows LAPACK geqrf: R on/above the diagonal, the Householder
vectors' tails below it (unit diagonal implicit), plus a tau vector.
``qr_col_piv`` (Businger-Golub, LAPACK geqp3) is the JAX package's
left-looking pivoted panel, its column loop run eagerly with the pivot
index on the device.  TSQR (``panel='tsqr'``, ``tsqr``) and
checksum-guarded QR belong to later slices.
"""
from __future__ import annotations

import math

import torch

from ..core.dist import MC, MR, STAR, VC
from ..core.distmatrix import DistMatrix
from ..core.environment import check_precision
from ..core.view import view, update_view
from ..redist.engine import apply_fault, redistribute, transpose_dist
from ..redist.interior import interior_view
from ..blas.level1 import make_trapezoidal
from ..blas.level3 import _check_mcmr, trsm
from ..kernels import qr_panel as _kernel_qr_panel
from ..kernels import resolve_panel
from ..kernels.qr_panel import _larft, _panel_qr, _panel_v
from ..matrices.basic import identity
from ..obs.tracer import NULL_HOOK as _NULL_TIMER, phase_hook as _phase_hook
from ..tune.policy import blocksize_policy as _blocksize, resolve_auto
from .cholesky import _check_knobs
from .lu import (_nopiv_panel, _update_cols_ge, _update_cols_lt,
                 permute_cols, permute_rows)


def _panel_qr_dispatch(P, plan=None):
    """One classic replicated panel through the resolved ``panel_impl``
    plan: ``(packed, tau, T)``, with ``T`` the kernel's block-reflector
    triangle when the plan selects the kernel for the panel's dtype, else
    ``None`` after the plain recurrence: the caller then builds T with
    :func:`_larft` from the packed panel as it leaves the ``'compute'``
    fault seam, as the JAX package's plain path does."""
    if plan is not None and plan.use_kernel(P.dtype):
        return _kernel_qr_panel(P)
    Pf, tau = _panel_qr(P)
    return Pf, tau, None


def _check_qr_knobs(nb, panel, comm_precision, redist_path, timer) -> str:
    """Check the knobs (``'auto'`` already resolved) and refuse unknown
    panel strategies; return the panel strategy."""
    _check_knobs(nb, None, None, comm_precision, redist_path, timer)
    if panel is None:
        panel = "classic"
    if panel not in ("classic", "tsqr"):
        raise ValueError(f"qr: unknown panel strategy {panel!r}; "
                         "expected 'classic', 'tsqr', or 'auto'")
    return panel


# ---------------------------------------------------------------------
# TSQR/CAQR tree panel: local Householder QR per grid-row slab, a
# log-depth pairwise reduction of the R factors, and the aggregated thin
# Q converted back to geqrf packing by the LU-based Householder
# reconstruction (Ballard/Demmel et al., "Reconstructing Householder
# vectors from TSQR"), so every downstream consumer -- the compact-WY
# updates, apply_q, least_squares -- is unchanged
# ---------------------------------------------------------------------

def _tsqr_tree(P, r: int):
    """Replicated TSQR reduction of an (M, b) panel over ``r`` cyclic
    grid-row slabs: returns ``(Q1, R)`` with Q1 the explicit thin
    orthonormal factor (rows in original order) and R upper triangular.
    The slab QRs are independent (one batched QR); ceil(log2 r) pairwise
    stacked-QR playoffs combine the R factors, with each leaf's b x b
    aggregated transform accumulated so Q1 is assembled by one matmul per
    slab."""
    M, b = P.shape
    dev = P.device
    lslab = max(-(-M // r), b)
    sidx = (torch.arange(lslab, device=dev)[None, :] * r
            + torch.arange(r, device=dev)[:, None])
    ok = sidx < M                                        # (r, lslab)
    vals = torch.where(ok[:, :, None], P[sidx.clamp(0, M - 1)], 0)
    Qs, Rs = torch.linalg.qr(vals, mode="reduced")
    Rlist = [Rs[i] for i in range(r)]
    groups = [[i] for i in range(r)]
    Ts = [None] * r                                      # None == identity
    while len(Rlist) > 1:
        nR, nG = [], []
        for a in range(0, len(Rlist) - 1, 2):
            q, rnew = torch.linalg.qr(torch.cat([Rlist[a], Rlist[a + 1]]),
                                      mode="reduced")
            for leaf, blk in ((groups[a], q[:b]), (groups[a + 1], q[b:])):
                for i in leaf:
                    Ts[i] = blk if Ts[i] is None else Ts[i] @ blk
            nR.append(rnew)
            nG.append(groups[a] + groups[a + 1])
        if len(Rlist) % 2:
            nR.append(Rlist[-1])
            nG.append(groups[-1])
        Rlist, groups = nR, nG
    eye = torch.eye(b, dtype=P.dtype, device=dev)
    T = torch.stack([eye if t is None else t for t in Ts])
    Qfull = torch.bmm(Qs, T)                             # (r, lslab, b)
    targets = torch.where(ok, sidx, M).reshape(-1)
    Q1 = P.new_zeros((M + 1, b))                         # spare row: padding
    Q1[targets] = Qfull.reshape(r * lslab, b)
    return Q1[:M], Rlist[0]


def _panel_qr_tsqr(P, r: int):
    """TSQR tree panel in geqrf packing: ``(packed V\\R, tau)``, the
    contract of the classic panel.

    The tree (:func:`_tsqr_tree`) gives the explicit thin ``Q1`` and
    ``R``; the Householder form follows from ``Q1 - [I; 0] = Y U`` (Y the
    unit-lower-trapezoidal reflector panel, ``U = -T Y1^H``), i.e. ONE
    unpivoted LU of ``Q1 - I`` (LU's :func:`_nopiv_panel`) with
    ``tau_j = -U[j,j]``.  Columns are sign-flipped first so the diagonal
    of ``Q1 - I`` stays away from zero."""
    M, b = P.shape
    Q1, R = _tsqr_tree(P, max(int(r), 1))
    d = torch.diagonal(Q1[:b])
    absd = d.abs()
    s = torch.where(absd == 0, -torch.ones_like(d),
                    -(d.conj() / torch.where(absd == 0, 1, absd)))
    s = s.to(P.dtype)
    Q1p = Q1 * s[None, :]
    Rp = s.conj()[:, None] * R
    B = Q1p.clone()
    B[:b] -= torch.eye(b, dtype=P.dtype, device=P.device)
    F = _nopiv_panel(B, b)
    tau = -torch.diagonal(F[:b])
    packed = torch.cat([torch.triu(Rp) + torch.tril(F[:b], -1), F[b:]])
    return packed, tau


def _local_qr_array(A: DistMatrix, ib: int, plan, redist_path=None,
                    tm=_NULL_TIMER):
    """Blocked Householder QR of a 1x1-grid matrix on ONE clone of its
    storage: returns ``(packed, tau)`` as new tensors.  Per panel the
    packed panel is written back, then the trailing columns get the
    compact-WY update in place.  The panel gather and the two relands of
    the distributed loop are 1x1 retags, issued as such (no copy) so the
    redistribution counts are the JAX driver's; ``tm`` gets the
    distributed loop's ticks ("panel", then "update" with the whole
    storage)."""
    a = A.local.clone(memory_format=torch.contiguous_format)
    g = A.grid
    m, n = a.shape
    kend = min(m, n)
    taus = []
    for s in range(0, kend, ib):
        e = min(s + ib, kend)
        blk = DistMatrix(a[s:, s:e], (m - s, e - s), MC, MR, 0, 0, g)
        P = redistribute(blk, STAR, STAR, path=redist_path).local
        Pf, tau, T = _panel_qr_dispatch(P, plan)
        Pf, = apply_fault("compute", (Pf,))
        taus.append(tau)
        tm.tick("panel", s // ib, Pf, tau)
        Pf_ss = DistMatrix(Pf, (m - s, e - s), STAR, STAR, 0, 0, g)
        a[s:, s:e] = redistribute(Pf_ss, MC, MR).local
        if e < n:
            Vp = _panel_v(Pf)
            if T is None:
                T = _larft(Vp, tau)
            V_ss = DistMatrix(Vp, (m - s, e - s), STAR, STAR, 0, 0, g)
            V = redistribute(V_ss, MC, STAR).local
            A2 = a[s:, e:]
            W = T.conj().mT @ (V.conj().mT @ A2)
            A2.addmm_(V, W, alpha=-1)
            tm.tick("update", s // ib, a)
    tau = torch.cat(taus) if taus else a.new_zeros((0,))
    return a, tau


def qr(A: DistMatrix, nb: int | None = None, precision=None,
       panel: str = "classic", panel_impl: str | None = None,
       comm_precision: str | None = None, timer=None, health=None,
       redist_path: str | None = None, abft=None):
    """Blocked Householder QR; returns ``(packed, tau)`` in geqrf format.

    The block size actually used is attached to the packed matrix (the
    ``_qr_nb`` attribute), so :func:`apply_q` called with ``nb=None``
    reuses the factorization's blocking and a mismatching explicit ``nb``
    raises instead of silently producing a wrong Q.

    ``panel`` is ``'classic'`` (the replicated larfg recurrence) or
    ``'tsqr'``: the TSQR tree panel (:func:`_panel_qr_tsqr`) -- slab QRs
    per grid row, a log-depth R reduction and the Householder
    reconstruction into the same geqrf packing, so ``apply_q`` /
    ``least_squares`` consume it unchanged (R's diagonal signs may differ
    from classic).  The tree runs on every grid, one slab on a 1x1 grid,
    as in the JAX package.

    ``panel_impl`` (``None`` | ``'auto'`` | ``'torch'`` | ``'kernel'``)
    selects the classic panel's implementation; ``None`` and ``'auto'``
    take the CUDA kernel for a real dtype on the card and the plain
    recurrence elsewhere; the tree panel keeps its slab QRs.
    ``precision`` is ``None`` or ``'highest'`` (full float32/float64
    arithmetic; on the card ``torch.backends.cuda.matmul.allow_tf32``
    must be False).  ``comm_precision`` (``None`` | ``'bf16'`` |
    ``'int8'``) and ``redist_path`` (``None`` | ``'chain'`` |
    ``'direct'``) select the wire precision and route of the per-step
    panel gathers.

    ``health`` attaches the numerical-health guards
    (:mod:`..resilience.health`; ``True`` lands the report in
    ``resilience.last_health_report('qr')``).  ``abft`` (``True`` or an
    ``AbftGuard``) runs the checksum-guarded schedule with per-panel
    rollback (:func:`..resilience.abft.abft_qr`) under either ``panel``,
    on every grid, 1x1 included.

    Any of ``nb`` / ``panel`` / ``comm_precision`` / ``redist_path`` /
    ``panel_impl`` may be ``'auto'``: the tuner (:mod:`..tune`) resolves
    them (measured cache first, analytic cost model cold; explicit values
    always win).  ``timer`` raises ``NotImplementedError`` (a later
    slice)."""
    _check_mcmr(A)
    nb, panel, panel_impl, comm_precision, redist_path = resolve_auto(
        "qr", A.gshape, A.dtype, A.grid, nb=nb, panel=panel,
        panel_impl=panel_impl, comm_precision=comm_precision,
        redist_path=redist_path).values()
    panel = _check_qr_knobs(nb, panel, comm_precision, redist_path, timer)
    check_precision(precision, A.local)
    plan = resolve_panel(panel_impl, dtype=A.dtype, device=A.local.device)
    if abft:
        from ..resilience.abft import abft_qr
        return abft_qr(A, nb=nb, precision=precision, panel=panel,
                       comm_precision=comm_precision, timer=timer,
                       health=health, abft=abft, plan=plan)
    m, n = A.gshape
    g = A.grid
    r, c = g.height, g.width
    ib = _blocksize(nb, math.lcm(r, c), min(m, n))
    tm = _phase_hook("qr", timer)
    hm = None
    if health:
        from ..resilience.health import attach_health
        tm, hm = attach_health("qr", health, tm, scale_from=A)
    tm.start()
    if g.size == 1 and panel == "classic":
        a, tau = _local_qr_array(A, ib, plan, redist_path, tm)
        Ap = A.with_local(a)
        _record_qr_nb(Ap, ib)
        if hm is not None:
            hm.report()
        return Ap, tau
    kend = min(m, n)
    taus = []
    for k, s in enumerate(range(0, kend, ib)):
        e = min(s + ib, kend)
        nbw = e - s
        e_up = min(-(-e // c) * c, n)
        panel_ss = redistribute(view(A, rows=(s, m), cols=(s, e_up)),
                                STAR, STAR, comm_precision=comm_precision,
                                path=redist_path)
        if panel == "tsqr":
            Pf, tau = _panel_qr_tsqr(panel_ss.local[:, :nbw], r)
            T = None
        else:
            Pf, tau, T = _panel_qr_dispatch(panel_ss.local[:, :nbw], plan)
        Pf, = apply_fault("compute", (Pf,))
        taus.append(tau)
        tm.tick("panel", k, Pf, tau)
        Pf_w = torch.nn.functional.pad(Pf, (0, e_up - e)) if e_up > e else Pf
        Pf_ss = DistMatrix(Pf_w, (m - s, e_up - s), STAR, STAR, 0, 0, g)
        A = _update_cols_lt(A, redistribute(Pf_ss, MC, MR), (s, m),
                            (s, e_up), e)
        if e < n:
            V = _panel_v(Pf)
            if T is None:
                T = _larft(V, tau)
            V_ss = DistMatrix(V, (m - s, nbw), STAR, STAR, 0, 0, g)
            V_mc = redistribute(V_ss, MC, STAR)
            A2 = view(A, rows=(s, m), cols=(s, n))
            W = V_mc.local.conj().mT @ A2.local        # [STAR,MR] storage
            W = T.conj().mT @ W
            A = _update_cols_ge(A, A2.with_local(
                torch.addmm(A2.local, V_mc.local, W, alpha=-1)), (s, m),
                (s, n), e)
            tm.tick("update", k, A)
    _record_qr_nb(A, ib)
    if hm is not None:
        hm.report()
    tau = torch.cat(taus) if taus else A.local.new_zeros((0,))
    return A, tau


def _record_qr_nb(Ap: DistMatrix, ib: int) -> None:
    """Attach the block size a factorization actually used to the packed
    matrix (frozen dataclass => object.__setattr__).  Host-side metadata
    only: ``with_local`` and friends drop it."""
    object.__setattr__(Ap, "_qr_nb", int(ib))


def _applyq_blocksize(Ap: DistMatrix, nb, grain: int, kend: int) -> int:
    """The blocking :func:`apply_q` must sweep with: default to the block
    size recorded by :func:`qr`, and REFUSE a mismatching explicit ``nb``
    (different panel boundaries silently produce a wrong Q)."""
    rec = getattr(Ap, "_qr_nb", None)
    if nb is None:
        return rec if rec is not None else _blocksize(None, grain, kend)
    nb, = resolve_auto("qr", Ap.gshape, Ap.dtype, Ap.grid, nb=nb).values()
    ib = _blocksize(nb, grain, kend)
    if rec is not None and ib != rec:
        raise ValueError(
            f"apply_q: nb={nb!r} derives block size {ib}, but this packed "
            f"factor was produced by qr() with block size {rec}; pass "
            "nb=None to reuse the factorization's blocking")
    return ib


def apply_q(Ap: DistMatrix, tau, B: DistMatrix, orient: str = "N",
            nb: int | None = None, precision=None) -> DistMatrix:
    """B := Q B ('N') or Q^H B ('C'), Q from (packed, tau)
    (``qr::ApplyQ`` / ``ApplyPackedReflectors``).

    Each panel's T is rebuilt with :func:`_larft` (a blocked build, a
    few launches a panel).  ``nb`` MUST match the factorization's blocking: the
    default (``None``) reuses the block size :func:`qr` recorded on
    ``Ap``; an explicit ``nb`` that derives different panel boundaries
    raises ``ValueError``."""
    _check_mcmr(Ap, B)
    check_precision(precision, Ap.local, B.local)
    m, n = Ap.gshape
    if B.gshape[0] != m:
        raise ValueError(f"B height {B.gshape[0]} != {m}")
    g = Ap.grid
    r, c = g.height, g.width
    kend = min(m, n)
    ib = _applyq_blocksize(Ap, nb, math.lcm(r, c), kend)
    starts = list(range(0, kend, ib))
    if orient == "N":
        starts = starts[::-1]
    local = g.size == 1
    if local:
        b = B.local.clone(memory_format=torch.contiguous_format)
    for s in starts:
        e = min(s + ib, kend)
        nbw = e - s
        e_up = min(-(-e // c) * c, n)
        # on a 1x1 grid both moves are retags of views (no copy)
        panel = redistribute(view(Ap, rows=(s, m), cols=(s, e_up)),
                             STAR, STAR)
        V = _panel_v(panel.local[:, :nbw])
        T = _larft(V, tau[s:e])
        Tm = T.conj().mT if orient == "C" else T
        V_ss = DistMatrix(V, (m - s, nbw), STAR, STAR, 0, 0, g)
        V_mc = redistribute(V_ss, MC, STAR)
        if local:
            b[s:].addmm_(V, Tm @ (V.conj().mT @ b[s:]), alpha=-1)
            continue
        B2 = view(B, rows=(s, m))
        W = V_mc.local.conj().mT @ B2.local
        W = Tm @ W
        upd = V_mc.local @ W
        B = update_view(B, B2.with_local(B2.local - upd), rows=(s, m))
    return B.with_local(b) if local else B


def explicit_q(Ap: DistMatrix, tau, nb: int | None = None,
               precision=None) -> DistMatrix:
    """The m x m unitary Q as a DistMatrix (``qr::ExplicitUnitary``)."""
    eye = identity(Ap.gshape[0], grid=Ap.grid, dtype=Ap.dtype)
    return apply_q(Ap, tau, eye, orient="N", nb=nb, precision=precision)


def least_squares(A: DistMatrix, B: DistMatrix, nb: int | None = None,
                  precision=None, abft=None) -> DistMatrix:
    """Minimize ||A X - B||_F for m >= n via QR (``El::LeastSquares``,
    dense path of ``src/lapack_like/euclidean_min/LeastSquares.cpp``):
    Q^H B via the packed reflectors, then a triangular solve against the
    interior-extracted R.  ``abft`` threads through to :func:`qr`: the
    factorization runs checksum-guarded with per-panel rollback."""
    _check_mcmr(A, B)
    m, n = A.gshape
    if m < n:
        raise ValueError("least_squares requires m >= n (tall)")
    Ap, tau = qr(A, nb=nb, precision=precision, abft=abft)
    Y = apply_q(Ap, tau, B, orient="C", nb=nb, precision=precision)
    R = make_trapezoidal(interior_view(Ap, (0, n), (0, n)), "U")
    Y1 = interior_view(Y, (0, n), (0, B.gshape[1]))
    return trsm("L", "U", "N", R, Y1, nb=nb, precision=precision)


# ---------------------------------------------------------------------
# LQ (via the QR of the adjoint) and RQ (via the exchange identity)
# ---------------------------------------------------------------------

def lq(A: DistMatrix, nb: int | None = None, precision=None,
       redist_path: str | None = None):
    """LQ factorization ``A = L Q`` (``El::LQ``), computed as the QR of
    ``A^H``.  Returns ``(packed, tau)``, the geqrf-packed QR of ``A^H``
    ((n, m)-shaped); use :func:`apply_q_lq` / :func:`explicit_l` to
    consume it.  ``redist_path`` routes the entry transpose and the QR
    panel gathers (``'auto'``: the engine's arbitration for the transpose,
    the tuner for the QR)."""
    Ah = redistribute(transpose_dist(A, conj=True), MC, MR, path=redist_path)
    return qr(Ah, nb=nb, precision=precision, redist_path=redist_path)


def apply_q_lq(Ap: DistMatrix, tau, B: DistMatrix, orient: str = "N",
               nb: int | None = None, precision=None) -> DistMatrix:
    """B := Q B ('N') or Q^H B ('C') with Q the LQ unitary (Q = Q_r^H of
    the underlying adjoint-QR)."""
    flip = "C" if orient == "N" else "N"
    return apply_q(Ap, tau, B, orient=flip, nb=nb, precision=precision)


def explicit_l(Ap: DistMatrix) -> DistMatrix:
    """The explicit (m, min(m,n)) lower-trapezoidal L from :func:`lq`'s
    packing (L = R^H of the adjoint QR; shape is read from ``Ap``)."""
    n_, m_ = Ap.gshape                      # Ap is the packed QR of A^H
    k = min(n_, m_)
    R = make_trapezoidal(interior_view(Ap, (0, k), (0, m_)), "U")
    return redistribute(transpose_dist(R, conj=True), MC, MR)


def rq(A: DistMatrix, nb: int | None = None, precision=None):
    """RQ factorization ``A = R Q`` (``El::RQ``) with R (m, k) upper
    triangular/trapezoidal against the BOTTOM-RIGHT corner and Q (k, n)
    having orthonormal rows (k = min(m, n)).

    With J the anti-identity, J_m A J_n = L W (LQ), so A = (J_m L J_k)
    (J_k W J_n).  Returns explicit ``(R, Q)``.  W's first k rows come
    from applying Q^H to the (n, k) identity slab and taking the
    adjoint."""
    m, n = A.gshape
    k = min(m, n)
    dev = A.local.device
    rev_m = torch.arange(m - 1, -1, -1, device=dev)
    rev_n = torch.arange(n - 1, -1, -1, device=dev)
    rev_k = torch.arange(k - 1, -1, -1, device=dev)
    Af = permute_cols(permute_rows(A, rev_m), rev_n)     # J_m A J_n
    packed, tau = lq(Af, nb=nb, precision=precision)
    L = explicit_l(packed)                               # (m, k)
    eye = identity(n, grid=A.grid, dtype=A.dtype)
    Ik = interior_view(eye, (0, n), (0, k)) if k < n else eye
    Wh = apply_q_lq(packed, tau, Ik, orient="C", nb=nb,
                    precision=precision)                 # (n, k) = W^H
    W = redistribute(transpose_dist(Wh, conj=True), MC, MR)
    R = permute_cols(permute_rows(L, rev_m), rev_k)
    Q = permute_cols(permute_rows(W, rev_k), rev_n)
    return R, Q


# ---------------------------------------------------------------------
# Column-pivoted QR (Businger-Golub / geqp3)
# ---------------------------------------------------------------------

def _panel_qp(stor, colnorms, s: int, m: int, n: int, nbw: int,
              Sc: int, Sr: int):
    """One left-looking pivoted panel (LAPACK ``laqps`` analog).

    Columns are identified by GLOBAL id throughout (the F accumulator is
    indexed by global column), so no physical swaps happen inside the
    panel; ``stor`` is the panel-start full storage snapshot.  Per column:
    the max-norm pivot (``argmax`` on the device, first index of a tie),
    one column fetch and one row fetch with their corrections, one
    reflector and the norm downdates.  Returns (V, F, packed R+v panel,
    tau, jpvt, updated colnorms)."""
    from .condense import _larfg_at
    mt = m - s
    dtype = stor.dtype
    dev = stor.device
    rdtype = torch.empty((), dtype=dtype).real.dtype
    ridx = torch.arange(mt, device=dev)
    lr, lc = -(-m // Sc), -(-n // Sr)
    grow = torch.arange(s, m, device=dev)
    srow = (grow % Sc) * lr + grow // Sc
    gcol = torch.arange(n, device=dev)
    scol = (gcol % Sr) * lc + gcol // Sr
    # the full-width row strip of the snapshot (rows [s, m) in global order)
    strip = stor.index_select(0, srow).index_select(1, scol)
    V = torch.zeros((mt, nbw), dtype=dtype, device=dev)
    F = torch.zeros((n, nbw), dtype=dtype, device=dev)
    P = torch.zeros((mt, nbw), dtype=dtype, device=dev)
    tau = torch.zeros((nbw,), dtype=dtype, device=dev)
    jpvt = torch.zeros((nbw,), dtype=torch.long, device=dev)
    norms = colnorms.to(rdtype).clone()
    for k in range(nbw):
        gc = norms.argmax().reshape(1)
        jpvt[k:k + 1] = gc
        c = strip.index_select(1, gc)[:, 0] - V @ F.index_select(0, gc)[0].conj()
        kt = torch.full((1,), k, dtype=torch.long, device=dev)
        v, tq, beta = _larfg_at(c, kt, ridx)
        # packed column: R above the pivot, beta on it, v's tail below
        pc = torch.where(ridx < k, c, 0)
        pc = torch.where(ridx == k, beta.to(dtype), pc)
        P[:, k] = torch.where(ridx > k, v, pc)
        V[:, k] = v
        tau[k:k + 1] = tq
        f = tq * (strip.mH @ v - F @ (V.mH @ v))
        F[:, k] = f
        # R row k across all columns (V and F now hold column k, whose
        # V[k, k] = 1 carries the new reflector)
        rowk = strip[k] - F.conj() @ V[k]
        down = rowk.abs() ** 2
        # downdate only live columns; used ones carry the -1 sentinel
        norms = torch.where(norms < 0, norms,
                            torch.sqrt(torch.clamp_min(norms ** 2 - down, 0.0)))
        norms.index_fill_(0, gc, -1.0)
    return V, F, P, tau, jpvt, norms


def qr_col_piv(A: DistMatrix, nb: int | None = None, precision=None):
    """Column-pivoted QR ``A[:, jpvt] = Q R`` (``El::qr::BusingerGolub`` /
    LAPACK geqp3).  Returns ``(packed, tau, jpvt)`` in geqrf packing with
    greedy max-norm pivot order (R's diagonal is non-increasing in
    magnitude); ``jpvt`` is an int64 tensor on the grid's device.

    Norm downdates use the squared recurrence with clamping but WITHOUT
    LAPACK's cancellation-triggered exact recomputation (the JAX
    package's documented deviation)."""
    from ..blas.level1 import _global_indices
    _check_mcmr(A)
    check_precision(precision, A.local)
    m, n = A.gshape
    g = A.grid
    r, c = g.height, g.width
    Sc, Sr = A.col_stride, A.row_stride
    ib = _blocksize(nb, math.lcm(r, c), min(m, n))
    kend = min(m, n)
    dev = A.local.device
    # initial exact column norms (storage columns are global columns;
    # padding columns land in a spare slot)
    ns = torch.linalg.vector_norm(A.local, dim=0)
    _, J = _global_indices(A)
    colnorms = torch.zeros((n + 1,), dtype=ns.dtype, device=dev)
    colnorms.index_copy_(0, torch.where(J < n, J, n), ns)
    colnorms = colnorms[:n]
    Awork = A
    panels, taus, jps = [], [], []
    for s in range(0, kend, ib):
        e = min(s + ib, kend)
        nbw = e - s
        V, F, P, tau, jpvt, colnorms = _panel_qp(
            Awork.local, colnorms, s, m, n, nbw, Sc, Sr)
        panels.append(P)
        taus.append(tau)
        jps.append(jpvt)
        if e < kend or e < n:
            # trailing update of rows [s, m) across the full width
            strip = view(Awork, rows=(s, m))
            Vmc = redistribute(DistMatrix(V, (m - s, nbw), STAR, STAR, 0, 0,
                                          g), MC, STAR)
            FH = redistribute(DistMatrix(F.mH, (nbw, n), STAR, STAR, 0, 0,
                                         g), STAR, MR)
            upd = Vmc.local @ FH.local
            Awork = update_view(Awork, strip.with_local(strip.local - upd),
                                rows=(s, m))
    jpvt = torch.cat(jps)
    tau = torch.cat(taus)
    # assemble: permute columns into pivot order, then overwrite each
    # panel's rows with its packed block
    full_perm = torch.cat([jpvt, _complement(jpvt, n)]) if n > kend else jpvt
    Ap = permute_cols(Awork, full_perm)
    for i, s in enumerate(range(0, kend, ib)):
        e = min(s + ib, kend)
        e_up = min(-(-e // c) * c, n)
        P = panels[i]
        if e_up > e:
            P = torch.nn.functional.pad(P, (0, e_up - e))
        blk = DistMatrix(P, (m - s, e_up - s), STAR, STAR, 0, 0, g)
        Ap = _update_cols_lt(Ap, redistribute(blk, MC, MR), (s, m),
                             (s, e_up), e)
    _record_qr_nb(Ap, ib)
    return Ap, tau, jpvt


def _complement(jpvt, n: int):
    """Global columns not chosen as pivots, ascending (a stable sort on
    the "chosen" flag, with no host sync)."""
    chosen = torch.zeros((n,), dtype=torch.int8, device=jpvt.device)
    chosen.index_fill_(0, jpvt, 1)
    return torch.argsort(chosen, stable=True)[:n - jpvt.shape[0]]


# ---------------------------------------------------------------------
# TSQR (tall-skinny)
# ---------------------------------------------------------------------

def tsqr(A: DistMatrix):
    """Tall-skinny QR of a [VC,STAR] matrix (``qr::TS``): every rank's
    local QR (one batched QR over the p blocks of the storage), the p
    small R factors stacked in VC rank order (one all-gather on a real
    grid) and factored once more, and each rank's Q block times its
    share of the second Q.  Returns (Q [VC,STAR] with orthonormal
    columns, R [STAR,STAR])."""
    if A.dist != (VC, STAR) or (A.calign, A.ralign) != (0, 0):
        raise ValueError(f"tsqr expects zero-aligned [VC,STAR], got {A}")
    m, k = A.gshape
    g = A.grid
    p = g.size
    if m < k:
        raise ValueError("tsqr needs m >= k")
    check_precision(None, A.local)
    lr = A.local.shape[0] // p
    q1, r1 = torch.linalg.qr(A.local.reshape(p, lr, k), mode="reduced")
    kk = r1.shape[1]
    q2, R = torch.linalg.qr(r1.reshape(p * kk, k), mode="reduced")
    Q = torch.bmm(q1, q2.reshape(p, kk, k)).reshape(p * lr, k)
    return (DistMatrix(Q, (m, k), VC, STAR, 0, 0, g),
            DistMatrix(R, (k, k), STAR, STAR, 0, 0, g))
