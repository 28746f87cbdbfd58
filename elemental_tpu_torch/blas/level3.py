"""Level-3 BLAS of the Cholesky slice: blocked Trsm.

PyTorch port of ``_check_mcmr``, ``_mask_triangle``, ``trsm``,
``_trsm_left`` and ``local_rank_update`` from
``elemental_tpu/blas/level3.py`` (Elemental ``src/blas_like/level3/Trsm``).

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

import torch

from ..core.dist import MC, MR, VR, STAR
from ..core.distmatrix import DistMatrix
from ..core.environment import check_precision
from ..core.view import view, update_view
from ..obs.tracer import NULL_HOOK as _NULL_HOOK, phase_hook as _phase_hook
from ..redist.engine import redistribute, transpose_dist
from ..tune.policy import blocksize_policy as _blocksize
from .level1 import _global_indices


def _check_mcmr(*Ms: DistMatrix):
    g = Ms[0].grid
    for A in Ms:
        if A.dist != (MC, MR) or (A.calign, A.ralign) != (0, 0):
            raise ValueError(f"expected zero-aligned [MC,MR] operand, got {A}")
        if A.grid != g:
            raise ValueError("operands on different grids")


def _mask_triangle(C: DistMatrix, uplo: str, strict: bool = False):
    """Boolean mask over C's storage selecting the given global triangle."""
    I, J = _global_indices(C)
    if uplo.upper().startswith("L"):
        return (J[None, :] < I[:, None]) if strict else (J[None, :] <= I[:, None])
    return (J[None, :] > I[:, None]) if strict else (J[None, :] >= I[:, None])


def _nonzero(x) -> bool:
    # complex(0) counts as zero
    return not (isinstance(x, (int, float, complex)) and x == 0)


def trsm(side: str, uplo: str, orient: str, A: DistMatrix, B: DistMatrix,
         alpha=1.0, unit: bool = False, nb: int | None = None,
         precision=None, comm_precision: str | None = None,
         redist_path: str | None = None) -> DistMatrix:
    """Solve op(A) X = alpha B (side 'L') or X op(A) = alpha B (side 'R');
    A triangular [MC,MR].  Reference: ``El::Trsm``.

    Right-side solves reduce to left solves of the transposed system
    (X op(A) = B  <=>  op(A)^T X^T = B^T).  ``nb='auto'``,
    ``comm_precision`` and ``redist_path`` belong to later slices and
    raise ``NotImplementedError``."""
    check_precision(precision, A.local, B.local)
    for name, v in (("comm_precision", comm_precision),
                    ("redist_path", redist_path)):
        if v is not None:
            raise NotImplementedError(
                f"trsm {name}={v!r} is not ported yet (a later slice)")
    if isinstance(nb, str):
        raise NotImplementedError(
            f"trsm nb={nb!r}: 'auto' needs the tuner (a later slice)")
    tm = _phase_hook("trsm")
    tm.start()
    trans = orient in ("T", "C")
    conj = orient == "C"
    if side.upper().startswith("R"):
        BT = redistribute(transpose_dist(B), MC, MR)
        # op(A)^T: N -> T; T -> N; C -> conj-only (trans=False, conj=True)
        XT = _trsm_left(uplo, not trans, conj, A, BT, alpha, unit, nb,
                        precision, tm)
        return redistribute(transpose_dist(XT), MC, MR)
    return _trsm_left(uplo, trans, conj, A, B, alpha, unit, nb, precision, tm)


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
               tm=_NULL_HOOK) -> DistMatrix:
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
        A11 = redistribute(view(A, rows=(s, e), cols=(s, e)), STAR, STAR)
        # mask to the stored triangle so opposite-triangle garbage (e.g. the
        # packed L\U format of lu()) can never leak into the solve
        a11 = torch.tril(A11.local) if lower else torch.triu(A11.local)
        B1 = redistribute(view(X, rows=(s, e)), STAR, VR)
        x1 = _solve_block(a11, B1.local, lower, trans, conj, unit)
        X1 = DistMatrix(x1, B1.gshape, STAR, VR, 0, 0, A.grid)
        X1_mr = redistribute(X1, STAR, MR)
        X = update_view(X, redistribute(X1_mr, MC, MR), rows=(s, e))  # local filter
        tm.tick("solve", k, X.local)
        # trailing update of the not-yet-solved rows
        lo, hi = (e, m) if forward else (0, s)
        if lo >= hi:
            continue
        if trans:
            # T21 = op(A)[hi-part, s:e] = op(A[s:e, hi-part])
            A1p = redistribute(view(A, rows=(s, e), cols=(lo, hi)), STAR, MC)
            a_loc = A1p.local.mT           # [MC,STAR]-storage of A1p^T
        else:
            A1p = redistribute(view(A, rows=(lo, hi), cols=(s, e)), MC, STAR)
            a_loc = A1p.local
        if conj:
            a_loc = a_loc.conj()
        X = local_rank_update(X, a_loc, X1_mr.local, rows=(lo, hi),
                              precision=precision)
        tm.tick("update", k, X.local)
    return X


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
