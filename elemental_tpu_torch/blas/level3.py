"""Level-3 BLAS: SUMMA Gemm, the rank-k updates, blocked Trsm, Trmm and
the two-sided transforms.

PyTorch port of ``elemental_tpu/blas/level3.py``, whole: ``gemm`` with
its SUMMA schedules (``_summa_c``, ``_summa_a``, ``_summa_b``,
``_summa_dot``, ``_summa_slice`` and the ``'gspmd'`` branch), ``trrk``,
``herk``, ``syrk``, ``trr2k``, ``her2k``, ``syr2k``, ``hemm``, ``symm``,
``trsm``, ``quasi_trsm``, ``multishift_trsm``, ``local_rank_update``,
``trmm``, ``two_sided_trsm`` and ``two_sided_trmm`` (Elemental
``src/blas_like/level3/``: ``Gemm``, ``Herk``/``Syrk``, ``Trrk``,
``Her2k``/``Syr2k``, ``Trr2k``, ``Hemm``/``Symm``, ``Trsm``,
``QuasiTrsm``, ``MultiShiftTrsm``, ``Trmm``, ``TwoSidedTrsm``,
``TwoSidedTrmm``).

The stacked-storage array of a DistMatrix is a row/column permutation of
the global matrix, so whenever two operands agree on the contraction
dimension's stride their storage arrays multiply directly:
``P A Q^T @ Q B R^T = P (A B) R^T``.  The trailing update of a panel
solve is therefore one local ``torch.matmul`` on [MC,STAR] x [STAR,MR]
storage, and the diagonal-block solve is ``torch.linalg.solve_triangular``
where the JAX package calls ``lax.linalg.triangular_solve``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dist import MC, MR, VC, VR, STAR
from ..core.distmatrix import DistMatrix, zeros as dm_zeros
from ..core.environment import check_precision
from ..core.view import view, update_view
from ..obs.tracer import NULL_HOOK as _NULL_HOOK, phase_hook as _phase_hook
from ..redist.engine import panel_spread, redistribute, transpose_dist
from ..redist.plan import gemm_slice_plans
from ..redist.quantize import check_comm_precision
from ..tune.policy import blocksize_policy as _blocksize, resolve_auto
from .level1 import _global_indices, get_diagonal, make_symmetric


def _check_mcmr(*Ms: DistMatrix):
    g = Ms[0].grid
    for A in Ms:
        if A.dist != (MC, MR) or (A.calign, A.ralign) != (0, 0):
            raise ValueError(f"expected zero-aligned [MC,MR] operand, got {A}")
        if A.grid != g:
            raise ValueError("operands on different grids")


def _orient(A: DistMatrix, orient: str) -> DistMatrix:
    """op(A) as a zero-aligned [MC,MR] matrix."""
    if orient == "N":
        return A
    return redistribute(transpose_dist(A, conj=(orient == "C")), MC, MR)


def _mask_triangle(C: DistMatrix, uplo: str, strict: bool = False):
    """Boolean mask over C's storage selecting the given global triangle."""
    I, J = _global_indices(C)
    if uplo.upper().startswith("L"):
        return (J[None, :] < I[:, None]) if strict else (J[None, :] <= I[:, None])
    return (J[None, :] > I[:, None]) if strict else (J[None, :] >= I[:, None])


def _nonzero(x) -> bool:
    # complex(0) counts as zero: a 0j beta must not force a complex
    # accumulator (and a TypeError out of _safe_astype) onto a real C
    return not (isinstance(x, (int, float, complex)) and x == 0)


def _safe_astype(x, dtype):
    """``x.to(dtype)`` that refuses to drop an imaginary part."""
    if x.is_complex() and not dtype.is_complex:
        raise TypeError(f"complex result cannot be stored in {dtype} output; "
                        "pass a complex C (or complex operands)")
    return x.to(dtype)


# ---------------------------------------------------------------------
# Gemm (SUMMA)
# ---------------------------------------------------------------------

def gemm(A: DistMatrix, B: DistMatrix, alpha=1.0, beta=0.0,
         C: DistMatrix | None = None, orient_a: str = "N",
         orient_b: str = "N", alg: str = "auto",
         nb: int | str | None = None, precision=None,
         comm_precision: str | None = None,
         redist_path: str | None = None) -> DistMatrix:
    """C := alpha op(A) op(B) + beta C on [MC,MR] (SUMMA, ``El::Gemm``).

    ``alg`` is one of 'A' / 'B' / 'C' (stationary A, B or C), 'dot'
    (inner dimension 1-D cyclic on both operands), 'gspmd' (one storage
    matmul) or 'slice' (one-sided slicing); 'dot', 'gspmd' and 'slice'
    ignore ``nb``.  On the virtual grid every schedule is storage
    matmuls on one device, so all give the same product up to the order
    of the sums.  ``comm_precision`` (``None`` | ``'bf16'`` | ``'int8'``)
    and ``redist_path`` (``None`` | ``'chain'`` | ``'direct'``) select the
    wire precision and route of the panel moves, as in the JAX driver
    ('slice' always takes the one-shot plans).  ``alg='auto'`` (the
    default) and ``'auto'`` for ``nb`` / ``comm_precision`` /
    ``redist_path`` resolve through the tuner (:mod:`..tune`: measured
    cache first, analytic cost model cold; on a 1x1 grid ``'dot'``, one
    local matmul).  The ``BlockMatrix`` read-proxy of the JAX package
    waits for ``core/block.py``."""
    check_precision(precision, A.local, B.local)
    A = _orient(A, orient_a)
    B = _orient(B, orient_b)
    _check_mcmr(A, B)
    m, k = A.gshape
    k2, n = B.gshape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {A.gshape} x {B.gshape}")
    if C is None:
        dt = torch.promote_types(A.dtype, B.dtype)
        if isinstance(alpha, complex) or isinstance(beta, complex):
            dt = torch.promote_types(dt, torch.complex64)
        C = dm_zeros(m, n, MC, MR, A.grid, dtype=dt)
        beta = 0.0
    else:
        _check_mcmr(A, B, C)
        if C.gshape != (m, n):
            raise ValueError(f"C shape {C.gshape} != ({m},{n})")
    alg, nb, comm_precision, redist_path = resolve_auto(
        "gemm", (m, k, n), C.dtype, A.grid, alg=alg, nb=nb,
        comm_precision=comm_precision, redist_path=redist_path).values()
    check_comm_precision(comm_precision)
    cp, rp = comm_precision, redist_path
    if alg == "C":
        return _summa_c(alpha, A, B, beta, C, nb, cp, rp)
    if alg == "A":
        return _summa_a(alpha, A, B, beta, C, nb, cp, rp)
    if alg == "B":
        return _summa_b(alpha, A, B, beta, C, nb, cp, rp)
    if alg == "dot":
        return _summa_dot(alpha, A, B, beta, C, cp, rp)
    if alg == "slice":
        return _summa_slice(alpha, A, B, beta, C, cp)
    if alg == "gspmd":
        # B's k-rows re-landed on A's k-column cyclic order ([MR,STAR]),
        # then one storage matmul
        Bk = redistribute(B, MR, STAR, comm_precision=cp)
        D = DistMatrix(A.local @ Bk.local, (m, n), MC, STAR, 0, 0, A.grid)
        return _finish(alpha, redistribute(D, MC, MR).local, beta, C)
    raise ValueError(f"unknown gemm alg {alg!r}")


def _finish(alpha, d, beta, C: DistMatrix) -> DistMatrix:
    """C := alpha d + beta C for a product ``d`` in C's storage order."""
    out = alpha * d
    if _nonzero(beta):
        out = out + beta * C.local
    return C.with_local(_safe_astype(out, C.dtype))


def _init_acc(beta, C: DistMatrix):
    return _safe_astype(beta * C.local, C.dtype) if _nonzero(beta) \
        else torch.zeros_like(C.local)


def _summa_c(alpha, A, B, beta, C, nb, cp=None, rp=None):
    """Stationary-C (``gemm::SUMMA_NNC``): per k-panel, A1 -> [MC,STAR],
    B1 -> [STAR,MR], and a local product accumulates into C's storage."""
    k = A.gshape[1]
    r, c = A.grid.height, A.grid.width
    kb = _blocksize(nb, math.lcm(r, c), k)
    acc = beta * C.local if _nonzero(beta) else torch.zeros_like(C.local)
    for s in range(0, k, kb):
        e = min(s + kb, k)
        A1 = redistribute(view(A, cols=(s, e)), MC, STAR, comm_precision=cp,
                          path=rp)
        B1 = redistribute(view(B, rows=(s, e)), STAR, MR, comm_precision=cp,
                          path=rp)
        acc = acc + alpha * (A1.local @ B1.local)
    return C.with_local(_safe_astype(acc, C.dtype))


def _summa_a(alpha, A, B, beta, C, nb, cp=None, rp=None):
    """Stationary-A (``gemm::SUMMA_NNA``): per C column panel, B1 ->
    [MR,STAR]; the storage product is the [MC,STAR] panel, filtered onto
    [MC,MR]."""
    m = A.gshape[0]
    n = B.gshape[1]
    jb = _blocksize(nb, A.grid.width, n)
    out = C.with_local(_init_acc(beta, C))
    for s in range(0, n, jb):
        e = min(s + jb, n)
        B1 = redistribute(view(B, cols=(s, e)), MR, STAR, comm_precision=cp,
                          path=rp)
        D1 = DistMatrix(A.local @ B1.local, (m, e - s), MC, STAR, 0, 0, A.grid)
        panel = redistribute(D1, MC, MR)
        cur = view(out, cols=(s, e))
        out = update_view(out, cur.with_local(
            cur.local + _safe_astype(alpha * panel.local, C.dtype)), cols=(s, e))
    return out


def _summa_b(alpha, A, B, beta, C, nb, cp=None, rp=None):
    """Stationary-B: per C row panel, A1^T -> [MC,STAR]; the storage
    product is the [STAR,MR] panel, filtered onto [MC,MR]."""
    m = A.gshape[0]
    n = B.gshape[1]
    ib = _blocksize(nb, A.grid.height, m)
    out = C.with_local(_init_acc(beta, C))
    for s in range(0, m, ib):
        e = min(s + ib, m)
        A1T = redistribute(transpose_dist(view(A, rows=(s, e))), MC, STAR,
                           comm_precision=cp, path=rp)
        D1 = DistMatrix(A1T.local.mT @ B.local, (e - s, n), STAR, MR, 0, 0,
                        A.grid)
        panel = redistribute(D1, MC, MR)
        cur = view(out, rows=(s, e))
        out = update_view(out, cur.with_local(
            cur.local + _safe_astype(alpha * panel.local, C.dtype)), rows=(s, e))
    return out


def _summa_dot(alpha, A, B, beta, C, cp=None, rp=None):
    """SUMMA-Dot (``gemm::SUMMA_NNDot``): the inner dimension 1-D cyclic
    on both operands ([STAR,VC] x [VC,STAR], the same permutation on each
    side), one storage product into the replicated C, filtered onto
    [MC,MR].  On a 1x1 grid the storage arrays are the global operands:
    one local matmul."""
    m, n = C.gshape
    if A.grid.size == 1:
        return _finish(alpha, A.local @ B.local, beta, C)
    Avc = redistribute(A, STAR, VC, comm_precision=cp, path=rp)
    Bvc = redistribute(B, VC, STAR, comm_precision=cp, path=rp)
    D = DistMatrix(Avc.local @ Bvc.local, (m, n), STAR, STAR, 0, 0, A.grid)
    return _finish(alpha, redistribute(D, MC, MR).local, beta, C)


def _summa_slice(alpha, A, B, beta, C, cp=None):
    """Slicing one-sided gemm: every rank owns a 1-D cyclic slice of C's
    rows (A -> [VC,STAR], B -> [STAR,STAR]) or columns ([STAR,STAR] x
    [STAR,VR]) and contracts locally; 1x1 is one local matmul.  The
    slices move through the one-shot plans of ``gemm_slice_plans``
    (``path='direct'``), so ``comm_precision`` applies per plan slot."""
    m, n = C.gshape
    g = A.grid
    if g.size == 1:
        return _finish(alpha, A.local @ B.local, beta, C)
    k = A.gshape[1]
    mode, _ = gemm_slice_plans(m, k, n, (g.height, g.width))
    if mode == "rows":
        As = redistribute(A, VC, STAR, comm_precision=cp, path="direct")
        Bs = redistribute(B, STAR, STAR, comm_precision=cp, path="direct")
        D = DistMatrix(As.local @ Bs.local, (m, n), VC, STAR, 0, 0, g)
    else:
        As = redistribute(A, STAR, STAR, comm_precision=cp, path="direct")
        Bs = redistribute(B, STAR, VR, comm_precision=cp, path="direct")
        D = DistMatrix(As.local @ Bs.local, (m, n), STAR, VR, 0, 0, g)
    return _finish(alpha, redistribute(D, MC, MR, path="direct").local, beta,
                   C)


# ---------------------------------------------------------------------
# Trrk / Herk / Syrk
# ---------------------------------------------------------------------

def trrk(uplo: str, alpha, A_mc: DistMatrix, B_mr: DistMatrix, beta,
         C: DistMatrix, precision=None) -> DistMatrix:
    """Triangular rank-k: C(tri) := alpha A B + beta C(tri), the other
    triangle untouched.  A is [MC,STAR], B is [STAR,MR] (the reference's
    ``LocalTrrk``): the full local product, masked to the triangle."""
    if A_mc.dist != (MC, STAR) or B_mr.dist != (STAR, MR):
        raise ValueError("trrk expects A [MC,STAR], B [STAR,MR]")
    _check_mcmr(C)
    check_precision(precision, A_mc.local, B_mr.local, C.local)
    tri_new = alpha * (A_mc.local @ B_mr.local) + beta * C.local
    return C.with_local(torch.where(_mask_triangle(C, uplo),
                                    _safe_astype(tri_new, C.dtype), C.local))


def herk(uplo: str, A: DistMatrix, alpha=1.0, beta=0.0,
         C: DistMatrix | None = None, orient: str = "N",
         nb: int | str | None = None, precision=None, conj: bool = True,
         comm_precision: str | None = None,
         redist_path: str | None = None) -> DistMatrix:
    """C(tri) := alpha op(A) op(A)^H + beta C(tri)  (orient 'N' or 'C'/'T').

    Per k-panel: A1 -> [VC,STAR], then ``panel_spread`` gives the
    [MC,STAR] panel and its [STAR,MR] adjoint, and one ``addmm_``
    accumulates their product into ONE buffer in place; the triangle is
    masked once at the end (in place when C starts at zero on a 1x1
    grid).  ``comm_precision`` selects the wire precision of the panel
    moves; ``redist_path='direct'`` replaces the [VC,STAR] hop + spread
    by one one-shot gather to [STAR,STAR] and two local filters.
    ``'auto'`` for ``nb`` / ``comm_precision`` / ``redist_path`` resolves
    through the tuner (:mod:`..tune`)."""
    check_precision(precision, A.local)
    if orient != "N":
        A = _orient(A, "C" if conj else "T")
    _check_mcmr(A)
    m, k = A.gshape
    nb, comm_precision, redist_path = resolve_auto(
        "herk", (m, k), A.dtype, A.grid, nb=nb,
        comm_precision=comm_precision, redist_path=redist_path).values()
    check_comm_precision(comm_precision)
    g = A.grid
    fresh = C is None
    if fresh:
        C = dm_zeros(m, m, MC, MR, g, dtype=A.dtype)
        beta = 0.0
    else:
        _check_mcmr(A, C)
        if C.gshape != (m, m):
            raise ValueError(f"C shape {C.gshape} != ({m},{m})")
    kb = _blocksize(nb, g.width, k)
    dt = torch.promote_types(A.dtype, C.dtype)
    if isinstance(alpha, complex) or isinstance(beta, complex):
        dt = torch.promote_types(dt, torch.complex64)
    acc = (beta * C.local).to(dt) if _nonzero(beta) \
        else torch.zeros(C.local.shape, dtype=dt, device=C.local.device)
    for s in range(0, k, kb):
        e = min(s + kb, k)
        if redist_path == "direct":
            # one one-shot exchange per panel; the [MC,STAR] panel and its
            # [STAR,MR] adjoint are then zero-round local filters
            A1_ss = redistribute(view(A, cols=(s, e)), STAR, STAR,
                                 comm_precision=comm_precision, path="direct")
            A1_mc = redistribute(A1_ss, MC, STAR)
            A1H_mr = redistribute(transpose_dist(A1_ss, conj=conj), STAR, MR)
        else:
            A1_vc = redistribute(view(A, cols=(s, e)), VC, STAR,
                                 comm_precision=comm_precision,
                                 path=redist_path)
            A1_mc, A1H_mr = panel_spread(A1_vc, conj=conj,
                                         comm_precision=comm_precision)
        acc.addmm_(A1_mc.local.to(dt), A1H_mr.local.to(dt), alpha=alpha)
    acc = _safe_astype(acc, C.dtype)
    if fresh and g.size == 1:
        # the storage is the global matrix: keep the triangle in place
        return C.with_local(acc.tril_() if uplo.upper().startswith("L")
                            else acc.triu_())
    return C.with_local(torch.where(_mask_triangle(C, uplo), acc, C.local))


def syrk(uplo: str, A: DistMatrix, alpha=1.0, beta=0.0,
         C: DistMatrix | None = None, orient: str = "N",
         nb: int | None = None, precision=None) -> DistMatrix:
    """C(tri) := alpha op(A) op(A)^T + beta C(tri) (``El::Syrk``)."""
    return herk(uplo, A, alpha, beta, C, orient=orient, nb=nb,
                precision=precision, conj=False)


# ---------------------------------------------------------------------
# Trr2k / Her2k / Syr2k
# ---------------------------------------------------------------------

def trr2k(uplo: str, alpha, A_mc: DistMatrix, B_mr: DistMatrix,
          beta, C_mc: DistMatrix, D_mr: DistMatrix, gamma, E: DistMatrix,
          precision=None) -> DistMatrix:
    """Triangular rank-2k: E(tri) := alpha A B + beta C D + gamma E(tri),
    the other triangle untouched (``El::Trr2k`` with [MC,STAR] x [STAR,MR]
    operand pairs, the reference's ``LocalTrr2k``)."""
    for X, d in ((A_mc, (MC, STAR)), (C_mc, (MC, STAR)),
                 (B_mr, (STAR, MR)), (D_mr, (STAR, MR))):
        if X.dist != d:
            raise ValueError(f"trr2k operand expected {d}, got {X.dist}")
    _check_mcmr(E)
    check_precision(precision, A_mc.local, C_mc.local, E.local)
    full = alpha * (A_mc.local @ B_mr.local) + beta * (C_mc.local @ D_mr.local)
    return E.with_local(torch.where(_mask_triangle(E, uplo),
                                    _safe_astype(full + gamma * E.local,
                                                 E.dtype), E.local))


def _conj_scalar(x):
    return x.conj() if torch.is_tensor(x) else x.conjugate()


def her2k(uplo: str, A: DistMatrix, B: DistMatrix, alpha=1.0, beta=0.0,
          C: DistMatrix | None = None, orient: str = "N", conj: bool = True,
          nb: int | None = None, precision=None) -> DistMatrix:
    """C(tri) := alpha op(A) op(B)^H + conj(alpha) op(B) op(A)^H + beta C(tri)
    (``El::Her2k``; ``conj=False`` gives ``Syr2k``, with ^T and alpha on
    both products).

    :func:`herk`'s panel schedule: per k-panel, ``panel_spread`` of A1
    and of B1, and two ``addmm_`` into ONE buffer in place; the triangle
    is masked once at the end."""
    check_precision(precision, A.local, B.local)
    if orient != "N":
        A = _orient(A, "C" if conj else "T")
        B = _orient(B, "C" if conj else "T")
    _check_mcmr(A, B)
    m, k = A.gshape
    if B.gshape != (m, k):
        raise ValueError(f"her2k needs conformal A,B; got {A.gshape} vs "
                         f"{B.gshape}")
    g = A.grid
    fresh = C is None
    if fresh:
        dt = torch.promote_types(A.dtype, B.dtype)
        if isinstance(alpha, complex):
            dt = torch.promote_types(dt, torch.complex64)
        C = dm_zeros(m, m, MC, MR, g, dtype=dt)
        beta = 0.0
    else:
        _check_mcmr(C)
        if C.gshape != (m, m):
            raise ValueError(f"C shape {C.gshape} != ({m},{m})")
    kb = _blocksize(nb, g.width, k)
    alpha2 = _conj_scalar(alpha) if conj else alpha
    dt = torch.promote_types(torch.promote_types(A.dtype, B.dtype), C.dtype)
    if isinstance(alpha, complex) or isinstance(beta, complex):
        dt = torch.promote_types(dt, torch.complex64)
    acc = (beta * C.local).to(dt) if _nonzero(beta) \
        else torch.zeros(C.local.shape, dtype=dt, device=C.local.device)
    for s in range(0, k, kb):
        e = min(s + kb, k)
        A1_mc, A1H_mr = panel_spread(
            redistribute(view(A, cols=(s, e)), VC, STAR), conj=conj)
        B1_mc, B1H_mr = panel_spread(
            redistribute(view(B, cols=(s, e)), VC, STAR), conj=conj)
        acc.addmm_(A1_mc.local.to(dt), B1H_mr.local.to(dt), alpha=alpha)
        acc.addmm_(B1_mc.local.to(dt), A1H_mr.local.to(dt), alpha=alpha2)
    acc = _safe_astype(acc, C.dtype)
    if fresh and g.size == 1:
        return C.with_local(acc.tril_() if uplo.upper().startswith("L")
                            else acc.triu_())
    return C.with_local(torch.where(_mask_triangle(C, uplo), acc, C.local))


def syr2k(uplo: str, A: DistMatrix, B: DistMatrix, alpha=1.0, beta=0.0,
          C: DistMatrix | None = None, orient: str = "N",
          nb: int | None = None, precision=None) -> DistMatrix:
    """C(tri) := alpha (op(A) op(B)^T + op(B) op(A)^T) + beta C(tri)
    (``El::Syr2k``)."""
    return her2k(uplo, A, B, alpha, beta, C, orient=orient, conj=False,
                 nb=nb, precision=precision)


# ---------------------------------------------------------------------
# Symm / Hemm
# ---------------------------------------------------------------------

def hemm(side: str, uplo: str, A: DistMatrix, B: DistMatrix, alpha=1.0,
         beta=0.0, C: DistMatrix | None = None, conj: bool = True,
         nb: int | None = None, precision=None) -> DistMatrix:
    """C := alpha A B + beta C (side 'L') or alpha B A + beta C ('R') with
    Hermitian A stored in the ``uplo`` triangle (``El::Hemm``;
    ``conj=False`` is ``Symm``): the full operand is formed once from the
    stored triangle (``make_symmetric``, which reads only that triangle),
    then one ``gemm``.  The JAX package lets the tuner pick the schedule;
    the port names ``alg='dot'``, on 1x1 one matmul."""
    _check_mcmr(A, B)
    full = make_symmetric(A, uplo, conj=conj)
    if side.upper().startswith("L"):
        return gemm(full, B, alpha=alpha, beta=beta, C=C, alg="dot", nb=nb,
                    precision=precision)
    return gemm(B, full, alpha=alpha, beta=beta, C=C, alg="dot", nb=nb,
                precision=precision)


def symm(side: str, uplo: str, A: DistMatrix, B: DistMatrix, alpha=1.0,
         beta=0.0, C: DistMatrix | None = None, nb: int | None = None,
         precision=None) -> DistMatrix:
    """``hemm`` without the conjugate (``El::Symm``)."""
    return hemm(side, uplo, A, B, alpha, beta, C, conj=False, nb=nb,
                precision=precision)


def trsm(side: str, uplo: str, orient: str, A: DistMatrix, B: DistMatrix,
         alpha=1.0, unit: bool = False, nb: int | None = None,
         precision=None, comm_precision: str | None = None,
         redist_path: str | None = None) -> DistMatrix:
    """Solve op(A) X = alpha B (side 'L') or X op(A) = alpha B (side 'R');
    A triangular [MC,MR].  Reference: ``El::Trsm``.

    Right-side solves reduce to left solves of the transposed system
    (X op(A) = B  <=>  op(A)^T X^T = B^T).  ``comm_precision`` selects
    the wire precision of the panel moves and ``redist_path`` their route
    (the entry/exit transposes of a right-side solve included).
    ``'auto'`` for ``nb`` / ``comm_precision`` / ``redist_path`` resolves
    through the tuner (:mod:`..tune`) as op ``'trsm'`` on B's shape."""
    check_precision(precision, A.local, B.local)
    nb, comm_precision, redist_path = resolve_auto(
        "trsm", B.gshape, B.dtype, B.grid, nb=nb,
        comm_precision=comm_precision, redist_path=redist_path).values()
    check_comm_precision(comm_precision)
    cp, rp = comm_precision, redist_path
    tm = _phase_hook("trsm")
    tm.start()
    trans = orient in ("T", "C")
    conj = orient == "C"
    if side.upper().startswith("R"):
        BT = redistribute(transpose_dist(B), MC, MR, path=rp)
        # op(A)^T: N -> T; T -> N; C -> conj-only (trans=False, conj=True)
        XT = _trsm_left(uplo, not trans, conj, A, BT, alpha, unit, nb,
                        precision, tm, cp, rp)
        return redistribute(transpose_dist(XT), MC, MR, path=rp)
    return _trsm_left(uplo, trans, conj, A, B, alpha, unit, nb, precision, tm,
                      cp, rp)


def _solve_block(a11, b1, lower: bool, trans: bool, conj: bool,
                 unit: bool):
    """op(a11) x = b1 for a triangular diagonal block (the counterpart of
    ``lax.linalg.triangular_solve(left_side=True, transpose_a=trans,
    conjugate_a=conj)``)."""
    op = a11.mT if trans else a11
    if conj:
        op = op.conj()
    return torch.linalg.solve_triangular(op, b1, upper=(lower == trans),
                                         left=True, unitriangular=unit)


def _trsm_left(uplo: str, trans: bool, conj: bool, A: DistMatrix, B: DistMatrix,
               alpha, unit: bool, nb: int | None, precision,
               tm=_NULL_HOOK, cp=None, rp=None) -> DistMatrix:
    """All eight left cases.  Effective triangle: uplo XOR trans decides the
    sweep direction; per panel the diagonal block is replicated
    ([STAR,STAR]), the RHS panel goes 1-D cyclic ([STAR,VR]) for the local
    triangular solve, and the off-diagonal product rides
    [MC,STAR] x [STAR,MR] storage (pure local)."""
    _check_mcmr(A, B)
    m, n = B.gshape
    if A.gshape != (m, m):
        raise ValueError(f"A {A.gshape} incompatible with B {B.gshape}")
    lower = uplo.upper().startswith("L")
    r, c = A.grid.height, A.grid.width
    ib = _blocksize(nb, math.lcm(r, c), m)
    X = B.with_local(alpha * B.local if _nonzero(alpha - 1) else B.local)
    starts = list(range(0, m, ib))
    forward = lower != trans        # effective-lower => forward sweep
    if not forward:
        starts = starts[::-1]
    for k, s in enumerate(starts):
        e = min(s + ib, m)
        A11 = redistribute(view(A, rows=(s, e), cols=(s, e)), STAR, STAR,
                           comm_precision=cp, path=rp)
        # mask to the stored triangle so opposite-triangle garbage (e.g. the
        # packed L\U format of lu()) can never leak into the solve
        a11 = torch.tril(A11.local) if lower else torch.triu(A11.local)
        B1 = redistribute(view(X, rows=(s, e)), STAR, VR, comm_precision=cp,
                          path=rp)
        x1 = _solve_block(a11, B1.local, lower, trans, conj, unit)
        X1 = DistMatrix(x1, B1.gshape, STAR, VR, 0, 0, A.grid)
        X1_mr = redistribute(X1, STAR, MR, comm_precision=cp, path=rp)
        X = update_view(X, redistribute(X1_mr, MC, MR), rows=(s, e))  # local filter
        tm.tick("solve", k, X.local)
        if e < m if forward else s > 0:
            X = _sweep_update(A, X, X1_mr, s, e, forward, trans, conj,
                              precision, cp, rp)
            tm.tick("update", k, X.local)
    return X


def _sweep_update(A: DistMatrix, X: DistMatrix, X1_mr: DistMatrix, s: int,
                  e: int, forward: bool, trans: bool, conj: bool,
                  precision, cp=None, rp=None) -> DistMatrix:
    """The off-panel update of a blocked triangular sweep (:func:`trsm`,
    :func:`quasi_trsm`, :func:`multishift_trsm`): the rows not yet solved
    lose op(A)[rows, s:e] X1, one storage product."""
    lo, hi = (e, X.gshape[0]) if forward else (0, s)
    if trans:
        # op(A)[hi-part, s:e] = op(A[s:e, hi-part])
        A1p = redistribute(view(A, rows=(s, e), cols=(lo, hi)), STAR, MC,
                           comm_precision=cp, path=rp)
        a_loc = A1p.local.mT           # [MC,STAR]-storage of A1p^T
    else:
        A1p = redistribute(view(A, rows=(lo, hi), cols=(s, e)), MC, STAR,
                           comm_precision=cp, path=rp)
        a_loc = A1p.local
    if conj:
        a_loc = a_loc.conj()
    return local_rank_update(X, a_loc, X1_mr.local, rows=(lo, hi),
                             precision=precision)


def local_rank_update(C: DistMatrix, A_loc, B_loc, rows=None, cols=None,
                      alpha=-1.0, precision=None) -> DistMatrix:
    """C[rows, cols] += alpha * A_loc @ B_loc on storage, pure-local.

    ``A_loc`` / ``B_loc`` are the STORAGE arrays of conforming [MC,STAR]
    and [STAR,MR] operands (rows/cols of the product land exactly on the
    view's cyclic layout), so the whole rank-k update is one local matmul
    + writeback -- the reference's ``LocalGemm`` trailing-update idiom."""
    sub = view(C, rows=rows, cols=cols)
    upd = torch.matmul(A_loc, B_loc)
    new = sub.local + (alpha * upd).to(C.dtype)
    return update_view(C, sub.with_local(new), rows=rows, cols=cols)


def quasi_trsm(side: str, orient: str, A: DistMatrix, B: DistMatrix,
               alpha=1.0, nb: int | None = None, precision=None
               ) -> DistMatrix:
    """Solve op(T) X = alpha B (side 'L') or X op(T) = alpha B (side 'R')
    with T UPPER QUASI-TRIANGULAR (real Schur form: 1x1 and 2x2 diagonal
    blocks, an upper triangle plus isolated subdiagonal entries;
    ``El::QuasiTrsm``).

    One host read of T's subdiagonal places the panel splits so that no
    2x2 block is cut; each replicated diagonal block is solved with
    ``torch.linalg.solve`` (a quasi-triangular block is not
    triangular-solvable), and the off-panel updates are :func:`trsm`'s
    storage products."""
    check_precision(precision, A.local, B.local)
    trans = orient in ("T", "C")
    conj = orient == "C"
    if side.upper().startswith("R"):
        BT = redistribute(transpose_dist(B), MC, MR)
        XT = _quasi_trsm_left(not trans, conj, A, BT, alpha, nb, precision)
        return redistribute(transpose_dist(XT), MC, MR)
    return _quasi_trsm_left(trans, conj, A, B, alpha, nb, precision)


def _quasi_trsm_left(trans: bool, conj: bool, A: DistMatrix, B: DistMatrix,
                     alpha, nb: int | None, precision) -> DistMatrix:
    _check_mcmr(A, B)
    m, n = B.gshape
    if A.gshape != (m, m):
        raise ValueError(f"A {A.gshape} incompatible with B {B.gshape}")
    r, c = A.grid.height, A.grid.width
    grain = math.lcm(r, c)
    ib = _blocksize(nb, grain, m)
    # the bump map (one O(m) host read): a split at e is legal iff
    # sub[e-1] == 0; splits stay on the distribution grain, so an illegal
    # split moves on by a whole grain
    sub = get_diagonal(A, offset=-1).local.cpu().numpy().ravel() if m > 1 \
        else np.zeros(0)
    starts = []
    s = 0
    while s < m:
        e = min(s + ib, m)
        while e < m and sub[e - 1] != 0:
            e = min(e + grain, m)         # never cut a 2x2 block
        starts.append((s, e))
        s = e
    X = B.with_local(alpha * B.local if _nonzero(alpha - 1) else B.local)
    forward = trans                       # effective-upper sweep direction
    if not forward:
        starts = starts[::-1]
    for s, e in starts:
        A11 = redistribute(view(A, rows=(s, e), cols=(s, e)), STAR, STAR)
        a11 = torch.triu(A11.local, -1)   # the upper triangle and the bumps
        B1 = redistribute(view(X, rows=(s, e)), STAR, VR)
        op = a11.mT if trans else a11
        if conj:
            op = op.conj()
        x1 = torch.linalg.solve(op, B1.local)
        X1 = DistMatrix(x1.to(X.dtype), B1.gshape, STAR, VR, 0, 0, A.grid)
        X1_mr = redistribute(X1, STAR, MR)
        X = update_view(X, redistribute(X1_mr, MC, MR), rows=(s, e))
        if e < m if forward else s > 0:
            X = _sweep_update(A, X, X1_mr, s, e, forward, trans, conj,
                              precision)
    return X


def trmm(side: str, uplo: str, orient: str, A: DistMatrix, B: DistMatrix,
         alpha=1.0, unit: bool = False, nb: int | None = None,
         precision=None) -> DistMatrix:
    """B := alpha op(tri(A)) B ('L') or alpha B op(tri(A)) ('R')
    (``El::Trmm``): the triangle, with an optional implicit unit
    diagonal, masked on storage, then one SUMMA ``gemm``.  The JAX
    package lets the tuner pick the schedule; the port names
    ``alg='dot'``, on 1x1 one full-precision matmul."""
    _check_mcmr(A, B)
    T = A.local.where(_mask_triangle(A, uplo, strict=unit), 0)
    if unit:
        I, J = _global_indices(A)
        on = (J[None, :] == I[:, None]) & (I[:, None] < A.gshape[0])
        T = torch.where(on, torch.ones((), dtype=A.dtype, device=T.device), T)
    Tm = A.with_local(T)
    if side.upper().startswith("L"):
        return gemm(Tm, B, alpha=alpha, orient_a=orient, alg="dot", nb=nb,
                    precision=precision)
    return gemm(B, Tm, alpha=alpha, orient_b=orient, alg="dot", nb=nb,
                precision=precision)


# ---------------------------------------------------------------------
# Two-sided transforms (generalized eigenproblem reductions)
# ---------------------------------------------------------------------

def two_sided_trsm(uplo: str, A: DistMatrix, L: DistMatrix,
                   nb: int | None = None, precision=None) -> DistMatrix:
    """Congruence solve: lower -> inv(L) A inv(L)^H, upper -> inv(U)^H A
    inv(U) (``El::TwoSidedTrsm``: reduces A x = lambda B x with B = L L^H /
    U^H U to a standard Hermitian problem).  A is read from the ``uplo``
    triangle; the result is returned full (Hermitian)."""
    full = make_symmetric(A, uplo, conj=True)
    if uplo.upper().startswith("L"):
        Y = trsm("L", "L", "N", L, full, nb=nb, precision=precision)
        return trsm("R", "L", "C", L, Y, nb=nb, precision=precision)
    Y = trsm("L", "U", "C", L, full, nb=nb, precision=precision)
    return trsm("R", "U", "N", L, Y, nb=nb, precision=precision)


def two_sided_trmm(uplo: str, A: DistMatrix, L: DistMatrix,
                   nb: int | None = None, precision=None) -> DistMatrix:
    """Congruence product: lower -> L^H A L, upper -> U A U^H
    (``El::TwoSidedTrmm``, the inverse transform of two_sided_trsm)."""
    full = make_symmetric(A, uplo, conj=True)
    if uplo.upper().startswith("L"):
        Y = trmm("L", "L", "C", L, full, nb=nb, precision=precision)
        return trmm("R", "L", "N", L, Y, nb=nb, precision=precision)
    Y = trmm("L", "U", "N", L, full, nb=nb, precision=precision)
    return trmm("R", "U", "C", L, Y, nb=nb, precision=precision)


# ---------------------------------------------------------------------
# MultiShiftTrsm (the Pseudospectra / TriangEig engine)
# ---------------------------------------------------------------------

#: most elements of one batch of shifted diagonal blocks (b d^2): the
#: multi-shift solve runs its (n, d, d) stack in chunks of this size
_MS_BATCH = 1 << 24


def _star_vr_colmap(n: int, p: int):
    """Static [STAR,VR] storage-column -> global-column map (zero align):
    (clipped global index per storage column, in-range mask), as CPU
    tensors."""
    lc = -(-n // p)
    q = np.arange(p)[:, None]
    jl = np.arange(lc)[None, :]
    perm = (jl * p + q).reshape(-1)
    return torch.as_tensor(np.clip(perm, 0, n - 1)), torch.as_tensor(perm < n)


def multishift_trsm(uplo: str, orient: str, A: DistMatrix, shifts,
                    B: DistMatrix, alpha=1.0, nb: int | None = None,
                    precision=None, diag_hook=None) -> DistMatrix:
    """Solve (op(tri(A)) - shifts[j] I) X[:, j] = alpha B[:, j] for all j at
    once (``El::MultiShiftTrsm``).

    :func:`trsm`'s blocked sweep; the diagonal-block solve becomes one
    batched triangular solve over the (columns, d, d) stack of shifted
    blocks of the [STAR,VR] panel (each storage column's shift picked by
    the static cyclic column map), in chunks of at most ``_MS_BATCH``
    elements; the trailing update is shift-free.

    ``diag_hook(M, sigma, global_col, global_rows)``, if given, may rewrite
    the shifted diagonal blocks before the solve, batched: ``M`` is
    (b, d, d), ``sigma`` and ``global_col`` are (b,), ``global_rows``
    (d,) (the JAX package's hook sees one column at a time under
    ``vmap``).  TriangEig's identity-row replacement rides this."""
    trans = orient in ("T", "C")
    conj = orient == "C"
    _check_mcmr(A, B)
    check_precision(precision, A.local, B.local)
    m, n = B.gshape
    if A.gshape != (m, m):
        raise ValueError(f"A {A.gshape} incompatible with B {B.gshape}")
    dev = A.local.device
    shifts = torch.as_tensor(shifts, device=dev)
    if tuple(shifts.shape) != (n,):
        raise ValueError(f"shifts must be ({n},), got {tuple(shifts.shape)}")
    lower = uplo.upper().startswith("L")
    g = A.grid
    r, c = g.height, g.width
    ib = _blocksize(nb, math.lcm(r, c), m)
    gcol, in_range = _star_vr_colmap(n, r * c)
    gcol, in_range = gcol.to(dev), in_range.to(dev)
    sig_stor = torch.where(in_range, shifts.index_select(0, gcol), 0)
    # (op(M) - sigma I) = op(M - sigma' I): untouched by T, conjugated by C
    sig = (sig_stor.conj() if conj else sig_stor).to(A.dtype)

    X = B.with_local(alpha * B.local if _nonzero(alpha - 1) else B.local)
    starts = list(range(0, m, ib))
    forward = lower != trans
    if not forward:
        starts = starts[::-1]
    for s in starts:
        e = min(s + ib, m)
        A11 = redistribute(view(A, rows=(s, e), cols=(s, e)), STAR, STAR)
        a11 = torch.tril(A11.local) if lower else torch.triu(A11.local)
        B1 = redistribute(view(X, rows=(s, e)), STAR, VR)
        d = a11.shape[0]
        eye = torch.eye(d, dtype=a11.dtype, device=dev)
        rowg = s + torch.arange(d, device=dev)
        ncol = B1.local.shape[1]
        step = max(1, _MS_BATCH // max(d * d, 1))
        x1 = torch.empty_like(B1.local)
        for c0 in range(0, ncol, step):
            c1 = min(c0 + step, ncol)
            M = a11 - sig[c0:c1, None, None] * eye
            if diag_hook is not None:
                M = diag_hook(M, sig[c0:c1], gcol[c0:c1], rowg)
            xb = _solve_block(M, B1.local[:, c0:c1].mT[..., None], lower,
                              trans, conj, False)
            x1[:, c0:c1] = xb[..., 0].mT
        X1 = DistMatrix(x1, B1.gshape, STAR, VR, 0, 0, g)
        X1_mr = redistribute(X1, STAR, MR)
        X = update_view(X, redistribute(X1_mr, MC, MR), rows=(s, e))
        if e < m if forward else s > 0:
            X = _sweep_update(A, X, X1_mr, s, e, forward, trans, conj,
                              precision)
    return X
