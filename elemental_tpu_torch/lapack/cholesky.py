"""Blocked distributed Cholesky + SPD solve, look-ahead pipelined.

PyTorch port of ``elemental_tpu/lapack/cholesky.py`` (Elemental
``src/lapack_like/factor/Cholesky.cpp`` + ``Cholesky/LVar3.hpp`` and
``src/lapack_like/solve/HPDSolve.cpp``).

Per panel (the LVar3 loop):
  A11 -> [STAR,STAR]            replicated diagonal block, local potrf
  A21 -> [VC,STAR]              1-D cyclic panel, local right-Trsm by L11^H
  (L21, L21^H) spread           ``panel_spread``: [MC,STAR] and the
                                [STAR,MR] adjoint
  A22 -= L21 L21^H (lower tri)  one storage matmul, masked

Every diagonal block goes through :func:`_potrf_inv`, which returns the
factor AND its inverse, so the panel solve is a matmul.  On a CUDA tensor
with a real dtype it runs the hand-written kernel
(``kernels/csrc/potrf_inv.cu``); elsewhere the plain PyTorch version.

Look-ahead (default on): step k's trailing update is split at the next
panel boundary -- the narrow strip of the next panel's columns is updated
first, diag block k+1 is factored and panel k+1 solved from it, and only
then do the wide remainder stripes run.  The strip and the remainder read
only the pre-update trailing matrix, so ``lookahead=False`` (the classic
right-looking order) gives the same factor up to roundoff.

``crossover``: once the distributed loop's trailing matrix drops to this
size it is gathered once to [STAR,STAR] and finished with the sequential
schedule (default 4096 with look-ahead, off for classic; 0 disables).

PyTorch updates tensors in place and JAX never does: the sequential
schedule works on ONE clone of its input and writes the factor's panels
into it, so ``cholesky(A)`` never changes ``A.local``.
"""
from __future__ import annotations

import math

import torch

from ..core.dist import MC, MR, VC, STAR
from ..core.distmatrix import DistMatrix
from ..core.environment import check_precision
from ..core.view import view, update_view
from ..redist.engine import (REDIST_PATHS, apply_fault, redistribute,
                             transpose_dist, panel_spread)
from ..redist.quantize import check_comm_precision
from ..blas.level1 import make_trapezoidal, _global_indices
from ..blas.level3 import _check_mcmr, _mask_triangle, trsm
from ..kernels import potrf_inv as _kernel_potrf_inv
from ..kernels import potrf_inv_reference, resolve_panel
from ..obs.tracer import NULL_HOOK as _NULL_TIMER, phase_hook as _phase_hook
from ..tune.policy import blocksize_policy as _blocksize, resolve_auto

#: Trailing-matrix size at which the distributed loop gathers the tail and
#: finishes locally (look-ahead schedule only, unless overridden).
_CROSSOVER = 4096

#: the plain PyTorch diagonal-block factor/inverse (the JAX package's
#: ``_potrf_inv_impl``)
_potrf_inv_impl = potrf_inv_reference


def _potrf_inv(D, precision, bs: int = 512, plan=None):
    """``(L, L^{-1})`` of a diagonal block through the ``'compute'`` seam:
    the kernel when ``plan`` selects it for the block's dtype, else
    :func:`_potrf_inv_impl`."""
    if plan is not None and plan.use_kernel(D.dtype):
        return apply_fault("compute", _kernel_potrf_inv(D, precision, bs=bs))
    return apply_fault("compute", _potrf_inv_impl(D, precision, bs))


def _local_chol_array(a, n: int, ib: int, precision, lookahead: bool = True,
                      timer=None, plan=None):
    """Blocked lower Cholesky of an (n, n) tensor (lower triangle valid),
    returning the lower-triangular factor as a NEW tensor.  Shared by the
    p == 1 driver and the distributed tail crossover.

    Schedule:
      * diagonal blocks factored by :func:`_potrf_inv` and the panel solve
        L21 = A21 L11^{-H} done as ONE matmul;
      * the rank-ib update touches only the LOWER triangle, via row-stripe
        blocks ``T[i:i+q, :i+q] -= L21[i:i+q] L21[:i+q]^H``;
      * ``lookahead=True`` first computes the next panel's column strip and
        factors diag block k+1 + its panel solve from it, then the wide
        remainder stripes (which read only the pre-update trailing matrix).

    Works in place on one clone of ``a``: the trailing matrix at step k is
    the view ``F[s:, s:]`` and finished panels are written into the
    columns they came from."""
    tm = timer if timer is not None else _NULL_TIMER
    q = 2 * ib
    F = a[:n, :n].clone(memory_format=torch.contiguous_format)
    nxt = None
    if lookahead:
        w0 = min(ib, n)
        L11, Li11 = _potrf_inv(F[:w0, :w0], precision, plan=plan)
        tm.tick("diag", 0, L11)
        L21 = None
        if w0 < n:
            L21 = F[w0:, :w0] @ Li11.mH
            tm.tick("panel", 0, L21)
        nxt = (L11, Li11, L21)
    for k, s in enumerate(range(0, n, ib)):
        w = min(ib, n - s)
        T = F[s:, s:]
        if lookahead:
            L11, Li11, L21 = nxt
        else:
            L11, Li11 = _potrf_inv(T[:w, :w], precision, plan=plan)
            tm.tick("diag", k, L11)
            L21 = None
            if s + w < n:
                L21 = T[w:, :w] @ Li11.mH
                tm.tick("panel", k, L21)
        # finished panel k goes into its own columns (no longer read)
        T[:w, :w] = L11
        if s + w == n:
            break
        T[w:, :w] = L21
        T2 = T[w:, w:]
        mt = T2.shape[0]
        if not lookahead:
            for i in range(0, mt, q):
                iq = min(i + q, mt)
                T2[i:iq, :iq] -= L21[i:iq, :] @ L21[:iq, :].mH
            tm.tick("update", k, T2)
            continue
        # look-ahead: the next panel's column strip updates first (one tall
        # narrow matmul), diag block k+1 factors + panel k+1 solves from it;
        # the wide remainder stripes read only columns >= w2 of the
        # pre-update T2, which the strip writeback does not touch.
        w2 = min(ib, mt)
        strip = T2[:, :w2] - L21 @ L21[:w2, :].mH
        L11n, Li11n = _potrf_inv(strip[:w2, :w2], precision, plan=plan)
        tm.tick("diag", k + 1, L11n)
        L21n = None
        if w2 < mt:
            L21n = strip[w2:, :] @ Li11n.mH
            tm.tick("panel", k + 1, L21n)
        nxt = (L11n, Li11n, L21n)
        T2[:, :w2] = strip
        for i in range(w2, mt, q):
            iq = min(i + q, mt)
            T2[i:iq, w2:iq] -= L21[i:iq, :] @ L21[w2:iq, :].mH
        tm.tick("update", k, T2)
    # the strict upper triangle still holds input values: the factor is
    # the lower triangle
    return F.tril_()


def _local_cholesky(A: DistMatrix, nb: int | None, precision,
                    lookahead: bool = True, timer=None,
                    plan=None) -> DistMatrix:
    """Sequential (p == 1) lower path: on a 1x1 grid the storage array IS
    the global matrix, so the whole blocked loop runs on it directly."""
    ib = max(nb or 2048, 1)
    out = _local_chol_array(A.local, A.gshape[0], ib, precision,
                            lookahead=lookahead, timer=timer, plan=plan)
    return A.with_local(out)


def _not_ported(name: str, value, what: str) -> None:
    raise NotImplementedError(
        f"{name}={value!r}: {what} is not ported yet (a later slice)")


def _check_knobs(nb, lookahead, crossover, comm_precision, redist_path,
                 timer) -> None:
    """Check the wire and route knobs (``'auto'`` is resolved by the
    caller before this) and refuse ``timer``, the phase tracer of a later
    slice."""
    check_comm_precision(comm_precision)
    if redist_path not in REDIST_PATHS:
        raise ValueError(f"redist_path must be one of {REDIST_PATHS}, got "
                         f"{redist_path!r}")
    if timer is not None:
        _not_ported("timer", timer, "phase timing")


def cholesky(A: DistMatrix, uplo: str = "L", nb: int | None = None,
             precision=None, lookahead: bool = True,
             crossover: int | None = None,
             panel_impl: str | None = None,
             comm_precision: str | None = None,
             redist_path: str | None = None, timer=None,
             health=None, abft=None) -> DistMatrix:
    """Cholesky factor of an HPD [MC,MR] matrix; reads only the ``uplo``
    triangle.  Returns L (A = L L^H) for 'L', U (A = U^H U) for 'U'.

    ``lookahead`` selects the pipelined schedule (``False`` restores the
    classic right-looking order); ``crossover`` is the trailing-matrix size
    at which the distributed loop gathers the tail once and finishes
    locally (``None`` = :data:`_CROSSOVER` with look-ahead, disabled
    classic; 0 never crosses over).

    ``panel_impl`` (``None`` | ``'auto'`` | ``'torch'`` | ``'kernel'``)
    selects the diagonal-block factor/inverse implementation; ``None`` and
    ``'auto'`` take the CUDA kernel for a real dtype on the card and the
    plain PyTorch version elsewhere (``None`` by device, see
    :mod:`..kernels`; ``'auto'`` through the tuner).

    ``precision`` is ``None`` or ``'highest'`` (full float32/float64
    arithmetic); on the card ``torch.backends.cuda.matmul.allow_tf32``
    must be False.

    ``comm_precision`` (``None`` | ``'bf16'`` | ``'int8'``) selects the
    wire precision of the bulk moves (diagonal-block and panel gathers,
    the panel spread, the crossover gather) and ``redist_path``
    (``None`` | ``'chain'`` | ``'direct'``) their route, as in the JAX
    driver.

    ``health`` attaches the numerical-health guards
    (:mod:`..resilience.health`): a ``HealthMonitor`` (read
    ``monitor.report()`` afterwards) or ``True`` (the report lands in
    ``resilience.last_health_report('cholesky')``); ``None`` attaches
    nothing.  ``abft`` (``True`` or an ``AbftGuard``) runs the
    checksum-guarded schedule with per-panel rollback
    (:func:`..resilience.abft.abft_cholesky`): the classic right-looking
    order on every grid, 1x1 included, whatever ``lookahead`` and
    ``crossover`` say.

    Any of ``nb`` / ``lookahead`` / ``crossover`` / ``comm_precision`` /
    ``redist_path`` / ``panel_impl`` may be ``'auto'``: the tuner
    (:mod:`..tune`) resolves them per (shape, dtype, grid, backend) --
    measured-cache winner first, analytic cost model cold; explicit values
    always win.  On the card it resolves ``panel_impl`` to ``'kernel'``
    for a real dtype.  ``timer`` raises ``NotImplementedError`` (the
    phase tracer is a later slice).
    """
    _check_mcmr(A)
    nb, lookahead, crossover, panel_impl, comm_precision, redist_path = \
        resolve_auto("cholesky", A.gshape, A.dtype, A.grid, nb=nb,
                     lookahead=lookahead, crossover=crossover,
                     panel_impl=panel_impl, comm_precision=comm_precision,
                     redist_path=redist_path).values()
    _check_knobs(nb, lookahead, crossover, comm_precision, redist_path,
                 timer)
    check_precision(precision, A.local)
    plan = resolve_panel(panel_impl, dtype=A.dtype, device=A.local.device)
    if uplo.upper().startswith("U"):
        # U = (lower factor of A^H-as-lower)^H; A hermitian so the data of
        # the upper triangle, conj-transposed, is the lower triangle.
        Alow = redistribute(transpose_dist(A, conj=True), MC, MR)
        L = cholesky(Alow, "L", nb=nb, precision=precision,
                     lookahead=lookahead, crossover=crossover,
                     panel_impl=panel_impl, comm_precision=comm_precision,
                     redist_path=redist_path, health=health, abft=abft)
        return redistribute(transpose_dist(L, conj=True), MC, MR)
    if abft:
        from ..resilience.abft import abft_cholesky
        return abft_cholesky(A, nb=nb, precision=precision,
                             comm_precision=comm_precision, timer=timer,
                             health=health, abft=abft, plan=plan)

    m = A.gshape[0]
    if A.gshape != (m, m):
        raise ValueError(f"cholesky needs square, got {A.gshape}")
    g = A.grid
    tm = _phase_hook("cholesky", timer)
    hm = None
    if health:
        from ..resilience.health import attach_health
        tm, hm = attach_health("cholesky", health, tm, scale_from=A)
    tm.start()
    if g.size == 1:
        out = _local_cholesky(A, nb, precision, lookahead, tm, plan)
        if hm is not None:
            hm.report()
        return out
    r, c = g.height, g.width
    cp, rp = comm_precision, redist_path
    ib = _blocksize(nb, math.lcm(r, c), m)
    xover = (_CROSSOVER if lookahead else 0) if crossover is None \
        else max(int(crossover), 0)
    L = A
    if lookahead:
        # prologue: factor diag block 0 + solve panel 0 from the input
        e0 = min(ib, m)
        A11 = redistribute(view(L, rows=(0, e0), cols=(0, e0)), STAR, STAR,
                           comm_precision=cp, path=rp)
        L11, Li11 = _potrf_inv(A11.local, precision, plan=plan)
        tm.tick("diag", 0, L11)
        L21_vc = None
        if e0 < m:
            A21_vc = redistribute(view(L, rows=(e0, m), cols=(0, e0)),
                                  VC, STAR, comm_precision=cp, path=rp)
            x21 = A21_vc.local @ Li11.mH
            L21_vc = DistMatrix(x21, (m - e0, e0), VC, STAR, 0, 0, g)
            tm.tick("panel", 0, L21_vc)
        nxt = (L11, Li11, L21_vc)
    for k, s in enumerate(range(0, m, ib)):
        e = min(s + ib, m)
        if lookahead:
            L11, Li11, L21_vc = nxt
        else:
            A11 = redistribute(view(L, rows=(s, e), cols=(s, e)), STAR, STAR,
                               comm_precision=cp, path=rp)
            # replicated diagonal-block factor + inverse, so the panel
            # Trsm below is a matmul
            L11, Li11 = _potrf_inv(A11.local, precision, plan=plan)
            tm.tick("diag", k, L11)
        L11_ss = DistMatrix(L11, (e - s, e - s), STAR, STAR, 0, 0, g)
        L = update_view(L, redistribute(L11_ss, MC, MR), rows=(s, e), cols=(s, e))
        if e == m:
            break
        if not lookahead:
            A21_vc = redistribute(view(L, rows=(e, m), cols=(s, e)), VC, STAR,
                                  comm_precision=cp, path=rp)
            x21 = A21_vc.local @ Li11.mH                     # A21 L11^{-H}
            L21_vc = DistMatrix(x21, (m - e, e - s), VC, STAR, 0, 0, g)
            tm.tick("panel", k, L21_vc)
        L21_mc, L21H_mr = panel_spread(L21_vc, conj=True, comm_precision=cp)
        tm.tick("spread", k, L21_mc, L21H_mr)
        tail = bool(xover) and m - e <= xover
        if not lookahead:
            A22 = view(L, rows=(e, m), cols=(e, m))
            upd = L21_mc.local @ L21H_mr.local
            mask = _mask_triangle(A22, "L")
            A22new = torch.where(mask, A22.local - upd, A22.local)
            L = update_view(L, A22.with_local(A22new), rows=(e, m), cols=(e, m))
            L = update_view(L, redistribute(L21_mc, MC, MR), rows=(e, m), cols=(s, e))
            tm.tick("update", k, L)
        else:
            # (a) narrow strip update: the next panel's columns of A22
            e2 = min(e + ib, m)
            A22a = view(L, rows=(e, m), cols=(e, e2))
            L21H_a = view(L21H_mr, cols=(0, e2 - e))
            maskA = _mask_triangle(A22a, "L")
            stripD = A22a.with_local(torch.where(
                maskA, A22a.local - L21_mc.local @ L21H_a.local, A22a.local))
            if not tail:
                # factor diag block k+1 + solve panel k+1 from the strip
                A11n = redistribute(view(stripD, rows=(0, e2 - e),
                                         cols=(0, e2 - e)), STAR, STAR,
                                    comm_precision=cp, path=rp)
                L11n, Li11n = _potrf_inv(A11n.local, precision, plan=plan)
                tm.tick("diag", k + 1, L11n)
                L21n_vc = None
                if e2 < m:
                    A21n = redistribute(view(stripD, rows=(e2 - e, m - e),
                                             cols=(0, e2 - e)), VC, STAR,
                                        comm_precision=cp, path=rp)
                    x21n = A21n.local @ Li11n.mH
                    L21n_vc = DistMatrix(x21n, (m - e2, e2 - e), VC, STAR,
                                         0, 0, g)
                    tm.tick("panel", k + 1, L21n_vc)
                nxt = (L11n, Li11n, L21n_vc)
            # (b) wide remainder update, from the pre-writeback operands
            restD = None
            if e2 < m:
                A22b = view(L, rows=(e, m), cols=(e2, m))
                L21H_b = view(L21H_mr, cols=(e2 - e, m - e))
                I, J = _global_indices(A22b)
                maskB = (J[None, :] + (e2 - e)) <= I[:, None]
                restD = A22b.with_local(torch.where(
                    maskB, A22b.local - L21_mc.local @ L21H_b.local,
                    A22b.local))
            L = update_view(L, redistribute(L21_mc, MC, MR), rows=(e, m), cols=(s, e))
            L = update_view(L, stripD, rows=(e, m), cols=(e, e2))
            if restD is not None:
                L = update_view(L, restD, rows=(e, m), cols=(e2, m))
            tm.tick("update", k, L)
        if tail:
            # crossover-to-local: one gather of the (fully updated) trailing
            # block, sequential finish, one scatter back
            Atail = redistribute(view(L, rows=(e, m), cols=(e, m)), STAR, STAR,
                                 comm_precision=cp, path=rp)
            lt = _local_chol_array(Atail.local, m - e, ib, precision,
                                   lookahead=lookahead, plan=plan)
            Lt_ss = DistMatrix(lt, (m - e, m - e), STAR, STAR, 0, 0, g)
            L = update_view(L, redistribute(Lt_ss, MC, MR),
                            rows=(e, m), cols=(e, m))
            tm.tick("tail", k, L)
            break
    if hm is not None:
        hm.report()
    return make_trapezoidal(L, "L")


def hpd_solve(A: DistMatrix, B: DistMatrix, uplo: str = "L",
              nb: int | None = None, precision=None, info: bool = False,
              health=None):
    """Solve A X = B for HPD A: Cholesky + forward/backward sweeps
    (``El::HPDSolve``).

    ``info=True`` returns ``(X, info)`` with the structured singularity
    signal ``{"singular", "diag_index", "finite"}`` from the factor's
    diagonal (a singular / non-PD A surfaces as a non-finite or
    non-positive diagonal entry instead of a silently NaN X); ``health``
    forwards to :func:`cholesky`.  For the residual-certified path use
    ``elemental_tpu_torch.resilience.certified_solve('hpd', A, B)``."""
    uplo = "U" if uplo.upper().startswith("U") else "L"
    F = cholesky(A, uplo, nb=nb, precision=precision, health=health)
    X = cholesky_solve_after(F, B, uplo, nb=nb, precision=precision)
    if not info:
        return X
    from ..resilience.health import factor_diag_info
    return X, factor_diag_info("hpd", F)


def cholesky_solve_after(L: DistMatrix, B: DistMatrix, uplo: str = "L",
                         nb: int | None = None, precision=None) -> DistMatrix:
    """Re-use an existing factor (``cholesky::SolveAfter``)."""
    if uplo.upper().startswith("U"):
        Y = trsm("L", "U", "C", L, B, nb=nb, precision=precision)
        return trsm("L", "U", "N", L, Y, nb=nb, precision=precision)
    Y = trsm("L", "L", "N", L, B, nb=nb, precision=precision)
    return trsm("L", "L", "C", L, Y, nb=nb, precision=precision)
