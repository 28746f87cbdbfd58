"""Ruiz + geometric matrix equilibration for the IPMs.

PyTorch port of ``elemental_tpu/optimization/equilibrate.py`` (Elemental
``El::RuizEquil``, ``El::GeomEquil``, ``El::SymmetricRuizEquil``), the
mandatory first step of every upstream IPM solve: A is rescaled to
D_r A D_c with near-unit row/column norms first and the solution mapped
back afterwards.

Scale vectors are replicated tensors on the grid's device (O(m + n)
against the O(mn) distributed operand); the row/column max reductions run
on the storage tensor (each global entry exactly once, padding masked)
and land through one ``scatter_reduce`` (a max or min is exact in any
order).
"""
from __future__ import annotations

import torch

from ..core.dist import STAR
from ..core.distmatrix import DistMatrix
from ..blas.level1 import _global_indices, diagonal_scale


def _real_dtype(dtype):
    return torch.zeros((), dtype=dtype).real.dtype


def _wrap(v, grid):
    """Replicated (k,) vector -> (k,1) [STAR,STAR] for diagonal_scale."""
    return DistMatrix(v.reshape(-1, 1), (v.shape[0], 1), STAR, STAR, 0, 0,
                      grid)


def _reduce_rows_cols(A: DistMatrix, a, fill, reduce: str):
    m, n = A.gshape
    I, J = _global_indices(A)
    red = torch.amax if reduce == "amax" else torch.amin
    rloc = red(a, dim=1)                            # per storage row
    cloc = red(a, dim=0)
    rowm = torch.full((m,), fill, dtype=a.dtype, device=a.device) \
        .scatter_reduce(0, I.clamp(0, m - 1), rloc, reduce)
    colm = torch.full((n,), fill, dtype=a.dtype, device=a.device) \
        .scatter_reduce(0, J.clamp(0, n - 1), cloc, reduce)
    return rowm, colm


def row_col_maxabs(A: DistMatrix):
    """Per-row and per-column max |A_ij| as replicated (m,), (n,) vectors."""
    m, n = A.gshape
    I, J = _global_indices(A)
    valid = (I[:, None] < m) & (J[None, :] < n)
    a = torch.where(valid, A.local.abs(), 0)
    return _reduce_rows_cols(A, a, 0.0, "amax")


def row_col_minabs(A: DistMatrix):
    """Per-row/column min of the NONZERO |A_ij| (zeros treated as absent;
    all-zero rows/cols report inf)."""
    m, n = A.gshape
    I, J = _global_indices(A)
    a = A.local.abs()
    valid = (I[:, None] < m) & (J[None, :] < n) & (a > 0)
    a = torch.where(valid, a, torch.inf)
    return _reduce_rows_cols(A, a, torch.inf, "amin")


def ruiz_equil(A: DistMatrix, iters: int = 6):
    """Ruiz iteration (``El::RuizEquil``): repeatedly scale rows and columns
    by 1/sqrt(max-abs), converging to unit row/column inf-norms.

    Returns (A_scaled = D_r A D_c, d_r, d_c) with the scale vectors
    replicated; recover original-variable quantities via x = D_c x~,
    y = D_r y~ (LP convention: A~x~=b~ with b~ = D_r b, c~ = D_c c)."""
    m, n = A.gshape
    dt = _real_dtype(A.dtype)
    dev = A.local.device
    d_r = torch.ones((m,), dtype=dt, device=dev)
    d_c = torch.ones((n,), dtype=dt, device=dev)
    As = A
    for _ in range(iters):
        rowm, colm = row_col_maxabs(As)
        sr = 1.0 / torch.sqrt(torch.clamp_min(rowm, 1e-30))
        sc = 1.0 / torch.sqrt(torch.clamp_min(colm, 1e-30))
        # all-zero rows/cols keep scale 1 (nothing to normalize)
        sr = torch.where(rowm > 0, sr, 1.0)
        sc = torch.where(colm > 0, sc, 1.0)
        As = diagonal_scale("L", _wrap(sr, A.grid), As)
        As = diagonal_scale("R", _wrap(sc, A.grid), As)
        d_r = d_r * sr
        d_c = d_c * sc
    return As, d_r, d_c


def geom_equil(A: DistMatrix, iters: int = 3):
    """Geometric-mean equilibration (``El::GeomEquil``): scale by
    1/sqrt(max * min_nonzero) per row/column -- centers the magnitude
    RANGE rather than the top."""
    m, n = A.gshape
    dt = _real_dtype(A.dtype)
    dev = A.local.device
    d_r = torch.ones((m,), dtype=dt, device=dev)
    d_c = torch.ones((n,), dtype=dt, device=dev)
    As = A
    for _ in range(iters):
        rmax, cmax = row_col_maxabs(As)
        rmin, cmin = row_col_minabs(As)
        sr = torch.where((rmax > 0) & torch.isfinite(rmin),
                         1.0 / torch.sqrt(torch.clamp_min(rmax * rmin,
                                                          1e-30)), 1.0)
        sc = torch.where((cmax > 0) & torch.isfinite(cmin),
                         1.0 / torch.sqrt(torch.clamp_min(cmax * cmin,
                                                          1e-30)), 1.0)
        As = diagonal_scale("L", _wrap(sr, A.grid), As)
        As = diagonal_scale("R", _wrap(sc, A.grid), As)
        d_r = d_r * sr
        d_c = d_c * sc
    return As, d_r, d_c


def symmetric_ruiz_equil(Q: DistMatrix, iters: int = 6):
    """Symmetric variant (``El::SymmetricRuizEquil``): one scale vector d
    with Q~ = D Q D (preserves symmetry/definiteness)."""
    n = Q.gshape[0]
    dt = _real_dtype(Q.dtype)
    d = torch.ones((n,), dtype=dt, device=Q.local.device)
    Qs = Q
    for _ in range(iters):
        rowm, _ = row_col_maxabs(Qs)
        s = torch.where(rowm > 0,
                        1.0 / torch.sqrt(torch.clamp_min(rowm, 1e-30)), 1.0)
        Qs = diagonal_scale("L", _wrap(s, Q.grid), Qs)
        Qs = diagonal_scale("R", _wrap(s, Q.grid), Qs)
        d = d * s
    return Qs, d
