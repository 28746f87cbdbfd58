"""Spectral layer: Hermitian eigensolvers.

PyTorch port of ``_sym_from_triangle``, ``_subset_slice``, ``herm_eig``,
``skew_herm_eig``, ``herm_gen_def_eig`` and ``hermitian_svd`` from
``elemental_tpu/lapack/spectral.py`` (Elemental
``src/lapack_like/spectral/HermitianEig.cpp``: tridiagonalize ->
tridiagonal EVP -> back-transform; ``HermitianGenDefEig``,
``SkewHermitianEig``, ``HermitianSVD``).

The tridiagonal EVP is solved redundantly on the replicated (d, e): by
``torch.linalg.eigh`` of the tridiagonal at n <= ``dc_min``, else by the
Cuppen divide and conquer of :mod:`.tridiag_eig`, whose eigenvector
matrix above ``repl_max`` only exists [MC,MR].  The O(n^3) work (the
reduction and the back-transform) stays distributed and matmul-shaped.
Subset eigenpairs select tridiagonal eigenvector columns before the
back-transform.  ``approach='qdwh'`` (``funcs.py``) and ``svd`` belong
to a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dist import MC, MR, STAR
from ..core.distmatrix import DistMatrix
from ..redist.engine import redistribute
from ..redist.interior import interior_view
from ..blas.level1 import _global_indices
from ..blas.level3 import _check_mcmr, trsm, two_sided_trsm
from .cholesky import cholesky
from .condense import hermitian_tridiag, apply_q_herm_tridiag, _real_dtype
from .lu import permute_cols
from .tridiag_eig import tridiag_eig

# Above this order the tridiagonal EVP switches from the replicated eigh to
# the Cuppen D&C; the switch is tied to repl_max (below it the D&C would
# run fully replicated anyway, at slightly lower accuracy than eigh).
_DC_MIN = 512
_REPL_MAX = 512


def _sym_from_triangle(Ag, uplo: str):
    """Rebuild the full Hermitian matrix from one stored triangle."""
    if uplo.upper().startswith("L"):
        t = torch.tril(Ag)
        return t + torch.tril(t, -1).mH
    t = torch.triu(Ag)
    return t + torch.triu(t, 1).mH


def _subset_slice(w, subset):
    """Resolve a HermitianEigSubset analog to a column slice (host-side).

    ``subset``: None (all), ``('index', il, iu)`` inclusive indices into
    the ascending spectrum, or ``('value', lo, hi)`` selecting the
    half-open interval (lo, hi] -- LAPACK range='V' semantics.  An
    optional 4th element overrides the searchsorted sides (internal; the
    skew translation uses it)."""
    n = w.shape[0]
    if subset is None:
        return 0, n
    kind = subset[0]
    if kind == "index":
        il, iu = subset[1], subset[2]
        return il, iu + 1
    if kind == "value":
        lo, hi = subset[1], subset[2]
        sides = subset[3] if len(subset) > 3 else ("right", "right")
        wn = w.detach().cpu().numpy()
        il = int(np.searchsorted(wn, lo, side=sides[0]))
        iu = int(np.searchsorted(wn, hi, side=sides[1]))
        return il, iu
    raise ValueError(f"bad subset {subset!r}")


def herm_eig(A: DistMatrix, uplo: str = "L", vectors: bool = True,
             subset=None, nb: int | None = None, approach: str = "tridiag",
             precision=None, dc_min: int | None = None,
             repl_max: int | None = None):
    """Eigendecomposition of a Hermitian [MC,MR] matrix: ``A = Z diag(w)
    Z^H`` (``El::HermitianEig``).  Returns ascending real ``w``
    (replicated) and, when ``vectors``, the distributed eigenvector
    matrix ``Z``.  ``approach='qdwh'`` needs ``funcs.py`` (a later slice)
    and raises ``NotImplementedError``."""
    _check_mcmr(A)
    n = A.gshape[0]
    if A.gshape != (n, n):
        raise ValueError(f"herm_eig needs square, got {A.gshape}")
    g = A.grid
    rdtype = _real_dtype(A.dtype)
    if n <= 2:
        Ag = _sym_from_triangle(redistribute(A, STAR, STAR).local, uplo)
        w, Z = torch.linalg.eigh(Ag)
        s, e = _subset_slice(w, subset)
        w = w[s:e].to(rdtype)
        if not vectors:
            return w
        return w, redistribute(
            DistMatrix(Z[:, s:e], (n, e - s), STAR, STAR, 0, 0, g), MC, MR)
    if approach == "qdwh":
        raise NotImplementedError(
            "herm_eig approach='qdwh' needs funcs.py, which is not ported "
            "yet (a later slice)")
    if approach != "tridiag":
        raise ValueError(f"herm_eig: unknown approach {approach!r}")
    Ap, d, e_, tau = hermitian_tridiag(A, uplo, nb=nb, precision=precision)
    dc_min = _DC_MIN if dc_min is None else dc_min
    repl_max = _REPL_MAX if repl_max is None else repl_max
    if n > dc_min:
        # the Cuppen D&C tridiagonal stage: above repl_max the eigenvector
        # matrix only ever exists [MC,MR]
        if not vectors:
            w = tridiag_eig(d, e_, grid=None, vectors=False,
                            repl_max=repl_max)
            s, e = _subset_slice(w, subset)
            return w[s:e].to(rdtype)
        w, ZTd = tridiag_eig(d, e_, grid=g, vectors=True, repl_max=repl_max)
        s, e = _subset_slice(w, subset)
        w = w[s:e].to(rdtype)
        if (s, e) != (0, n):
            ZTd = interior_view(ZTd, (0, n), (s, e))
        if ZTd.dtype != A.dtype:
            ZTd = ZTd.with_local(ZTd.local.to(A.dtype))
        Z = apply_q_herm_tridiag(Ap, tau, ZTd, orient="N", nb=nb,
                                 precision=precision)
        return w, Z
    # the redundant replicated tridiagonal solve
    T = (torch.diag(d) + torch.diag(e_, -1) + torch.diag(e_, 1)).to(rdtype)
    w, ZT = torch.linalg.eigh(T)
    s, e = _subset_slice(w, subset)
    w = w[s:e]
    if not vectors:
        return w
    ZTd = redistribute(DistMatrix(ZT[:, s:e].to(A.dtype), (n, e - s), STAR,
                                  STAR, 0, 0, g), MC, MR)
    Z = apply_q_herm_tridiag(Ap, tau, ZTd, orient="N", nb=nb,
                             precision=precision)
    return w, Z


def _translate_skew_subset(subset, n: int):
    """Map a subset request on the FINAL ascending imaginary parts
    ``m_j = -w_{n-1-j}`` to one on ``w = eig(iA)`` (ascending)."""
    if subset is None:
        return None
    kind = subset[0]
    if kind == "index":
        il, iu = subset[1], subset[2]
        return ("index", n - 1 - iu, n - 1 - il)
    if kind == "value":
        lo, hi = subset[1], subset[2]
        # m in (lo, hi]  <=>  w = -m in [-hi, -lo)
        return ("value", -hi, -lo, ("left", "left"))
    raise ValueError(f"bad subset {subset!r}")


def skew_herm_eig(A: DistMatrix, uplo: str = "L", vectors: bool = True,
                  subset=None, nb: int | None = None, precision=None,
                  approach: str = "tridiag"):
    """Eigenvalues (purely imaginary, returned as their imaginary parts,
    ascending) of a skew-Hermitian matrix: eig(iA) with a sign flip
    (``El::SkewHermitianEig``)."""
    cdtype = torch.promote_types(A.dtype, torch.complex64)
    iA = A.with_local(1j * A.local.to(cdtype))
    n = A.gshape[0]
    out = herm_eig(iA, uplo, vectors, _translate_skew_subset(subset, n), nb,
                   approach=approach, precision=precision)
    # eig(A) = -i * eig(iA): the imaginary parts are -w; re-sort ascending
    if not vectors:
        return -out.flip(0)
    w, Z = out
    k = Z.gshape[1]
    Zr = permute_cols(Z, torch.arange(k - 1, -1, -1)) if k > 1 else Z
    return -w.flip(0), Zr


def herm_gen_def_eig(A: DistMatrix, B: DistMatrix, uplo: str = "L",
                     vectors: bool = True, subset=None, nb: int | None = None,
                     precision=None, approach: str = "tridiag"):
    """Generalized definite pencil ``A x = w B x`` with HPD ``B``
    (``El::HermitianGenDefEig``, AXBX form): Cholesky B = L L^H, reduce
    via ``TwoSidedTrsm`` to ``L^-1 A L^-H``, solve, back-substitute
    ``x = L^-H y``."""
    L = cholesky(B, "L", nb=nb, precision=precision)
    C = two_sided_trsm(uplo, A, L, nb=nb, precision=precision)
    out = herm_eig(C, uplo, vectors, subset, nb=nb, approach=approach,
                   precision=precision)
    if not vectors:
        return out
    w, Y = out
    X = trsm("L", "L", "C", L, Y, nb=nb, precision=precision)
    return w, X


def hermitian_svd(A: DistMatrix, uplo: str = "L", vectors: bool = True,
                  nb: int | None = None, precision=None,
                  approach: str = "tridiag"):
    """SVD of a Hermitian matrix via its eigendecomposition
    (``El::HermitianSVD``): s = |w| descending, U = Z*sign(w), V = Z."""
    out = herm_eig(A, uplo, vectors, nb=nb, approach=approach,
                   precision=precision)
    if not vectors:
        return torch.sort(out.abs(), descending=True).values
    w, Z = out
    order = torch.argsort(-w.abs(), stable=True)
    s = w.abs()[order]
    signs = torch.where(w[order] < 0, -1.0, 1.0).to(A.dtype)
    V = permute_cols(Z, order)          # distributed column permutation
    # U = V diag(signs): each storage column scaled by its global column's
    # sign (the JAX package's diagonal_scale('R', ...))
    _, J = _global_indices(V)
    U = V.with_local(V.local * signs[J.clamp(0, signs.shape[0] - 1)][None, :])
    return U, s, V
