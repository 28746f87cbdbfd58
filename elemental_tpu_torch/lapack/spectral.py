"""Spectral layer: Hermitian eigensolvers and the SVD.

PyTorch port of ``elemental_tpu/lapack/spectral.py`` (Elemental
``src/lapack_like/spectral/HermitianEig.cpp``: tridiagonalize ->
tridiagonal EVP -> back-transform; ``HermitianGenDefEig``,
``SkewHermitianEig``, ``HermitianSVD``, ``SVD.cpp`` with its
``svd::Chan`` tall path).

The tridiagonal EVP is solved redundantly on the replicated (d, e): by
``torch.linalg.eigh`` of the tridiagonal at n <= ``dc_min``, else by the
Cuppen divide and conquer of :mod:`.tridiag_eig`, whose eigenvector
matrix above ``repl_max`` only exists [MC,MR].  The O(n^3) work (the
reduction and the back-transform) stays distributed and matmul-shaped.
Subset eigenpairs select tridiagonal eigenvector columns before the
back-transform.  ``herm_eig(approach='qdwh')`` is the polar-based
spectral divide and conquer of :mod:`.funcs`.  ``svd`` takes the Chan
route (QR, then the SVD of R) on a tall matrix, the QDWH polar route
(polar, then ``herm_eig`` of the polar factor H), the Golub-Kahan route
(``bidiag`` + the tridiagonal EVP of B^H B) or the replicated
``torch.linalg.svd`` of a small block.  Its ``gemm`` calls name
``alg='dot'``, where the JAX package lets the tuner pick.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dist import MC, MR, STAR
from ..core.distmatrix import DistMatrix
from ..redist.engine import redistribute, transpose_dist
from ..redist.interior import interior_view
from ..core.view import pad_matrix
from ..blas.level1 import diagonal_scale, make_trapezoidal
from ..blas.level3 import _check_mcmr, gemm, trsm, two_sided_trsm
from .cholesky import cholesky
from .condense import hermitian_tridiag, apply_q_herm_tridiag, _real_dtype
from .lu import permute_cols
from .qr import qr, apply_q
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
    matrix ``Z``.  ``approach='qdwh'`` takes the polar-based spectral
    divide and conquer (:func:`.funcs._qdwh_eig`)."""
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
        from .funcs import _qdwh_eig
        return _qdwh_eig(A, uplo, vectors, subset, nb, precision)
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
    d = DistMatrix(signs[:, None], (signs.shape[0], 1), STAR, STAR, 0, 0,
                   A.grid)
    U = diagonal_scale("R", d, V)
    return U, s, V


def svd(A: DistMatrix, vectors: bool = True, approach: str = "auto",
        nb: int | None = None, precision=None, eig_approach: str = "tridiag"):
    """Singular value decomposition ``A = U diag(s) V^H`` (``El::SVD``).

    ``approach``:
      * 'chan'  -- tall path (``svd::Chan``): QR first, SVD of the small R,
        U = Q U_R (the reference's default for m >= 1.5 n).
      * 'polar' -- QDWH polar + Hermitian eigensolve of the factor H.
      * 'golub' -- Bidiag + tridiagonal EVP of B^H B + back-transform
        (``svd::GolubReinsch`` analog; see :func:`_svd_golub_kahan`).
      * 'local' -- the replicated ``torch.linalg.svd`` of a small block.
      * 'auto'  -- 'chan' when m >= 1.5 n (or the mirrored transpose when
        n >= 1.5 m), else 'polar'.
    ``eig_approach`` is forwarded to the inner :func:`herm_eig` ('qdwh'
    selects the spectral D&C).  Returns (U, s, V) with s descending
    (replicated real vector)."""
    _check_mcmr(A)
    m, n = A.gshape
    g = A.grid
    if n > m:
        out = svd(redistribute(transpose_dist(A, conj=True), MC, MR),
                  vectors, approach, nb, precision, eig_approach)
        if not vectors:
            return out
        U, s, V = out
        return V, s, U
    if approach == "auto":
        approach = "chan" if m >= max(int(1.5 * n), n + 1) else "polar"

    if approach == "chan" and m > n:
        Ap, tau = qr(A, nb=nb, precision=precision)
        Rd = make_trapezoidal(interior_view(Ap, (0, n), (0, n)), "U")
        out = svd(Rd, vectors, "polar" if n > 128 else "local", nb,
                  precision, eig_approach)
        del Rd
        if not vectors:
            return out
        UR, s, V = out
        # U = Q [UR; 0] -- the row pad is a pure-local storage extension
        U0 = pad_matrix(UR, m, n)
        del UR
        U = apply_q(Ap, tau, U0, orient="N", nb=nb, precision=precision)
        return U, s, V

    if approach == "golub":
        return _svd_golub_kahan(A, vectors, nb, precision, eig_approach)

    if approach == "local" or (approach == "chan" and m == n):
        # replicated fallback for small blocks (the redundant-LAPACK analog)
        Ag = redistribute(A, STAR, STAR).local
        U, s, Vh = torch.linalg.svd(Ag, full_matrices=False)
        s = s.to(_real_dtype(A.dtype))
        if not vectors:
            return s
        Ud = redistribute(DistMatrix(U, (m, n), STAR, STAR, 0, 0, g), MC, MR)
        Vd = redistribute(DistMatrix(Vh.mH.contiguous(), (n, n), STAR, STAR,
                                     0, 0, g), MC, MR)
        return Ud, s, Vd

    if approach == "polar":
        return _svd_polar(A, vectors, nb, precision, eig_approach)
    raise ValueError(f"unknown svd approach {approach!r}")


def _svd_golub_kahan(A: DistMatrix, vectors: bool, nb, precision,
                     eig_approach: str):
    """Golub-Kahan path (``svd::GolubReinsch`` analog): Bidiag, then the
    symmetric tridiagonal EVP of B^H B, then back-transform
    U = Q [B V_B S^{-1}; 0], V = P V_B.

    Numerical note: forming B^H B squares the condition number; singular
    values below ~sqrt(eps)*s_max lose relative accuracy (use 'polar'
    when they matter)."""
    from ..blas.level1 import index_dependent_fill
    from ..core.distmatrix import zeros as dm_zeros
    from .condense import bidiag, apply_p_bidiag
    m, n = A.gshape
    g = A.grid
    rdtype = _real_dtype(A.dtype)
    Ap, d, e, tauq, taup = bidiag(A, nb=nb, precision=precision)
    zero = torch.zeros((1,), dtype=rdtype, device=d.device)
    epad = torch.cat([zero, e])            # e_{j-1} at j
    enext = torch.cat([e, zero])           # e_j at j
    esafe = e if e.shape[0] else zero
    T0 = dm_zeros(n, n, MC, MR, g, dtype=rdtype)

    def tfill(i, j):
        ic = i.clamp(0, n - 1)
        jc = j.clamp(0, n - 1)
        diag = d[ic] ** 2 + epad[ic] ** 2
        # (B^H B)[i, i+1] = d_i e_i ; [i+1, i] its conjugate (real here)
        sup = d[ic] * esafe[i.clamp(0, max(n - 2, 0))]
        sub = d[jc] * esafe[j.clamp(0, max(n - 2, 0))]
        return torch.where(i == j, diag,
                           torch.where(j == i + 1, sup,
                                       torch.where(i == j + 1, sub, 0.0)))

    T = index_dependent_fill(T0, tfill)
    out = herm_eig(T, "L", vectors, nb=nb, approach=eig_approach,
                   precision=precision)
    if not vectors:
        return torch.sqrt(torch.clamp(torch.sort(out, descending=True).values,
                                      min=0))
    w, Z = out
    order = torch.argsort(-w, stable=True)
    s = torch.sqrt(torch.clamp(w[order], min=0))
    # cast to A's dtype BEFORE the complex back-transforms (a real-typed VB
    # would silently truncate the reflectors' imaginary parts)
    VB = permute_cols(Z, order)
    VB = VB.with_local(VB.local.to(A.dtype))
    # U_B = B V_B S^{-1}: row i of B V_B = d_i VB[i,:] + e_i VB[i+1,:]
    dd = DistMatrix(d[:, None].to(A.dtype), (n, 1), STAR, STAR, 0, 0, g)
    ee = DistMatrix(enext[:, None].to(A.dtype), (n, 1), STAR, STAR, 0, 0, g)
    VBshift = pad_matrix(interior_view(VB, (1, n), (0, n)), n, n)
    BV = diagonal_scale("L", dd, VB)
    BV = BV.with_local(BV.local + diagonal_scale("L", ee, VBshift).local)
    sinv = torch.where(s > 0, 1.0 / torch.where(s == 0, 1.0, s), 0)
    ds = DistMatrix(sinv[:, None].to(A.dtype), (n, 1), STAR, STAR, 0, 0, g)
    UB = diagonal_scale("R", ds, BV)
    V = apply_p_bidiag(Ap, taup, VB, orient="N", nb=nb, precision=precision)
    U = apply_q(Ap, tauq, pad_matrix(UB, m, n), orient="N", nb=nb,
                precision=precision)
    return U, s, V


def _svd_polar(A: DistMatrix, vectors: bool, nb, precision,
               eig_approach: str):
    """Polar path: A = Up H; H = V diag(w) V^H; s = w descending;
    U = Up V."""
    from .funcs import polar
    Up, H = polar(A, nb=nb, precision=precision)
    if not vectors:
        w = herm_eig(H, "L", vectors=False, nb=nb, approach=eig_approach,
                     precision=precision)
        return torch.clamp(torch.sort(w, descending=True).values, min=0)
    w, V = herm_eig(H, "L", True, nb=nb, approach=eig_approach,
                    precision=precision)
    del H
    # H is PSD: w ascending >= 0 (up to rounding); descending order
    order = torch.argsort(-w, stable=True)
    s = torch.clamp(w[order], min=0)
    Vd = permute_cols(V, order)
    del V
    U = gemm(Up, Vd, alg="dot", precision=precision)
    return U, s, Vd
