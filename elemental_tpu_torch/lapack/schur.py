"""Schur decomposition (spectral divide and conquer), triangular
eigenvectors, the general eigensolver and pseudospectra.

PyTorch port of ``elemental_tpu/lapack/schur.py`` (Elemental
``src/lapack_like/spectral/Schur.cpp`` + ``Schur/SDC.hpp``: matrix-sign
spectral divide and conquer with randomized splitting lines;
``TriangEig.cpp`` via ``MultiShiftTrsm``; ``Eig.cpp``;
``Pseudospectra.cpp``).

* The SDC split is one scaled Newton ``sign`` per level, a randomized
  range finder and a packed-reflector rotation, with interior extract and
  embed at the data-dependent split.  Splitting lines are retried over
  rotations (vertical, horizontal, random angle).  The splitting lines and
  the range finder's G come from the JAX package's seeded numpy generator,
  so both packages try the same lines.
* The base case gathers the block and runs scipy's sequential complex QR
  algorithm on the host (the reference's redundant ``hseqr``).
* ``triang_eig`` batches all n shifted back-substitutions into one
  multi-shift sweep where rows >= j of column j's system become identity
  rows, so the singular shift T_jj = lambda_j never divides.
* ``pseudospectra`` runs inverse power iteration on (T - z I) for the whole
  shift grid at once through ``multishift_trsm``.

Output convention: COMPLEX Schur form (real input is cast), A = Q T Q^H
with T upper triangular.  The complex ``sign``, ``lu``, ``qr`` and
``apply_q`` run their plain paths: the CUDA panel kernels are real-only.
The JAX package lets the tuner pick each ``gemm`` schedule; the port
names ``alg='dot'``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dist import MC, MR, STAR
from ..core.distmatrix import DistMatrix, from_global, to_global
from ..redist.engine import redistribute, transpose_dist
from ..redist.interior import interior_view, interior_update, _blank
from ..blas.level1 import (get_diagonal, shift_diagonal, frobenius_norm,
                           make_trapezoidal, diagonal_scale, max_norm,
                           _global_indices)
from ..blas.level3 import _check_mcmr, gemm, multishift_trsm
from .funcs import sign as _matrix_sign
from .lu import permute_cols
from .qr import qr, apply_q


def _complex_dtype(dtype):
    return torch.promote_types(dtype, torch.complex64)


def _gemm(A, B, nb, precision, **kw):
    return gemm(A, B, alg="dot", nb=nb, precision=precision, **kw)


def _replicated_schur(A: DistMatrix):
    """Base case: gather + sequential complex QR algorithm, run on the host
    (the reference's redundant-hseqr fallback)."""
    import scipy.linalg
    n = A.gshape[0]
    Ag = to_global(A).cpu().numpy()
    T, Q = scipy.linalg.schur(Ag, output="complex")
    g = A.grid
    dev = A.local.device

    def dist(x):
        x = torch.as_tensor(x, device=dev).to(A.dtype)
        return redistribute(DistMatrix(x, (n, n), STAR, STAR, 0, 0, g),
                            MC, MR)
    return dist(T), dist(Q)


def _sdc(A: DistMatrix, base: int, nb, precision, seed: int, depth: int = 0):
    """Recursive sign-function SDC; returns (T, Q) with A = Q T Q^H."""
    n = A.gshape[0]
    g = A.grid
    if n <= max(base, 2) or depth > 60:
        return _replicated_schur(A)
    d = get_diagonal(A).local[:, 0].cpu().numpy()
    rng = np.random.default_rng(0x5DC0 + 31 * seed + depth)
    scale = max(float(frobenius_norm(A)), 1e-30)
    # candidate splitting lines: (shift sigma, rotation theta); the sign of
    # e^{-i theta}(A - sigma I) splits the spectrum across the line through
    # sigma with direction theta + pi/2
    cands = [(complex(float(np.median(np.real(d)))), 0.0),
             (1j * float(np.median(np.imag(d))), math.pi / 2)]
    for _ in range(3):
        c = complex(d[rng.integers(n)]) + \
            (rng.normal() + 1j * rng.normal()) * 0.1 * scale / math.sqrt(n)
        cands.append((c, rng.uniform(0, math.pi)))
    split = None
    for sigma, theta in cands:
        try:
            sig = torch.tensor(sigma, dtype=A.dtype)
            As = shift_diagonal(A, -sig)
            phase = torch.tensor(np.exp(-1j * theta), dtype=A.dtype)
            S = _matrix_sign(As.with_local(phase.to(As.local.device)
                                           * As.local),
                             nb=nb, precision=precision)
        except FloatingPointError:
            continue
        P = shift_diagonal(S.with_local(-0.5 * S.local), 0.5)
        kf = float(torch.where(_diag_mask(P), P.local, 0).sum().real)
        if not math.isfinite(kf):
            continue        # sign silently filled with NaN/Inf: next line
        k = int(round(kf))
        if not (0 < k < n):
            continue
        G = rng.normal(size=(n, k)) + 1j * rng.normal(size=(n, k))
        npdt = np.dtype(str(A.dtype).replace("torch.", ""))
        Gd = from_global(G.astype(npdt), MC, MR, grid=g)
        Y = _gemm(P, Gd, nb, precision)
        Qp, tau = qr(Y, nb=nb, precision=precision)
        T1_ = apply_q(Qp, tau, A, orient="C", nb=nb, precision=precision)
        T2_ = redistribute(transpose_dist(T1_, conj=True), MC, MR)
        T3_ = apply_q(Qp, tau, T2_, orient="C", nb=nb, precision=precision)
        C = redistribute(transpose_dist(T3_, conj=True), MC, MR)
        # accept only a numerically clean split: the rotated (2,1) block
        # must be negligible (an unconverged sign near the line leaves mass
        # there; the reference's SDC performs the same residual gate)
        A21 = interior_view(C, (k, n), (0, k))
        if float(frobenius_norm(A21)) > 1e-6 * scale:
            continue
        split = (k, Qp, tau, C)
        break
    if split is None:
        return _replicated_schur(A)
    k, Qp, tau, C = split
    A11 = interior_view(C, (0, k), (0, k))
    A22 = interior_view(C, (k, n), (k, n))
    C12 = interior_view(C, (0, k), (k, n))
    Ta, Qa = _sdc(A11, base, nb, precision, 2 * seed + 1, depth + 1)
    Tb, Qb = _sdc(A22, base, nb, precision, 2 * seed + 2, depth + 1)
    T12 = _gemm(_gemm(Qa, C12, nb, precision, orient_a="C"), Qb, nb,
                precision)
    T = _blank(n, n, A)
    T = interior_update(T, Ta, (0, 0))
    T = interior_update(T, T12, (0, k))
    T = interior_update(T, Tb, (k, k))
    BD = _blank(n, n, A)
    BD = interior_update(BD, Qa, (0, 0))
    BD = interior_update(BD, Qb, (k, k))
    Q = apply_q(Qp, tau, BD, orient="N", nb=nb, precision=precision)
    return make_trapezoidal(T, "U"), Q


def _diag_mask(A: DistMatrix):
    I, J = _global_indices(A)
    return (J[None, :] == I[:, None]) & (I[:, None] < A.gshape[0])


def _global_colnorms(X: DistMatrix, k: int):
    """Column 2-norms in GLOBAL order from the storage array.  Out-of-range
    (padding) storage columns land in a spare slot and are dropped."""
    ns = torch.linalg.vector_norm(X.local, dim=0)
    _, J = _global_indices(X)
    out = torch.zeros((k + 1,), dtype=ns.dtype, device=ns.device)
    out.index_copy_(0, torch.where(J < k, J, k), ns)
    return out[:k]


def _inverse_scale(norms, width: int, dtype, grid) -> DistMatrix:
    """The replicated (width, 1) diagonal 1 / norms (0 where a norm is 0)."""
    inv = torch.where(norms > 0, 1.0 / torch.where(norms == 0, 1, norms), 0)
    return DistMatrix(inv[:, None].to(dtype), (width, 1), STAR, STAR, 0, 0,
                      grid)


def schur(A: DistMatrix, base: int | None = None, nb: int | None = None,
          precision=None):
    """Complex Schur decomposition A = Q T Q^H (``El::Schur``; SDC path for
    blocks above ``base``).  Returns (T upper triangular, Q unitary)."""
    _check_mcmr(A)
    n = A.gshape[0]
    if A.gshape != (n, n):
        raise ValueError(f"schur needs square, got {A.gshape}")
    Ac = A.with_local(A.local.to(_complex_dtype(A.dtype)))
    return _sdc(Ac, base if base is not None else 128, nb, precision, seed=1)


def triang_eig(T: DistMatrix, nb: int | None = None, precision=None):
    """Eigenvectors of an upper-triangular T (``El::TriangEig``): one
    batched :func:`multishift_trsm` backward sweep whose diagonal blocks
    are modified per column -- rows >= j become identity rows (so the
    singular shift T_jj - lambda_j never divides) and near-zero pivots are
    clamped to ~eps ||T|| (LAPACK trevc's smin perturbation for repeated
    or defective eigenvalues).  Returns (w = diag(T), V) with unit 2-norm
    columns."""
    _check_mcmr(T)
    n = T.gshape[0]
    w = get_diagonal(T).local[:, 0]
    finfo = torch.finfo(T.local.real.dtype)
    smin = finfo.eps * torch.clamp_min(max_norm(T), 1e-300) + finfo.tiny

    def hook(M, sg, jg, rowg):
        # batched: rows >= j of column j's block become identity rows
        eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
        M = torch.where((rowg[None, :] >= jg[:, None])[:, :, None], eye, M)
        d_ = M.diagonal(dim1=-2, dim2=-1)
        mag = d_.abs()
        dc = torch.where(mag < smin,
                         torch.where(mag == 0, smin,
                                     d_ * (smin / torch.where(mag == 0, 1,
                                                              mag))),
                         d_)
        return M + torch.diag_embed(dc - d_)

    # RHS: e_j per column -- the modified system keeps column j's coupling
    # T[i, j] x[j], so rows i < j see exactly (T - lambda_j)[:j,:j] x = -T[:j, j]
    B = shift_diagonal(_blank(n, n, T), 1)
    X = multishift_trsm("U", "N", T, w, B, nb=nb, precision=precision,
                        diag_hook=hook)
    dinv = _inverse_scale(_global_colnorms(X, n), n, X.dtype, T.grid)
    return w, diagonal_scale("R", dinv, X)


def eig(A: DistMatrix, base: int | None = None, nb: int | None = None,
        precision=None):
    """General (non-Hermitian) eigendecomposition via Schur + TriangEig
    (``El::Eig``): returns (w, V) with A V ~= V diag(w), unit columns."""
    T, Q = schur(A, base=base, nb=nb, precision=precision)
    w, Vt = triang_eig(T, nb=nb, precision=precision)
    return w, _gemm(Q, Vt, nb, precision)


def pseudospectra(A: DistMatrix, re_window, im_window, nx: int = 20,
                  ny: int = 20, iters: int = 30, triangular: bool = False,
                  base: int | None = None, nb: int | None = None,
                  precision=None, seed: int = 0, tol: float = 1e-3,
                  check_every: int = 3, deflate: bool = True,
                  quiet_checks: int = 3, snapshot=None):
    """Inverse-norm map, estimated sigma_min(A - z I) over a 2-D shift
    window (``El::Pseudospectra``): Schur once, then batched inverse power
    iteration on (T - z I)^H (T - z I) through ``multishift_trsm``.

    Deflation (the ``Pseudospectra/{Power,Lanczos}.hpp`` machinery): every
    ``check_every`` sweeps, shifts whose estimate moved by less than
    ``tol`` relatively for ``quiet_checks`` CONSECUTIVE checks are FROZEN
    and removed from the batch (a loud check resets a shift's count); the
    active set repacks to the next power-of-two width.  ``snapshot``
    receives ``(sweep, Z, sigmin_so_far)`` after every check.

    Returns (Z grid (ny, nx) complex, sigmin (ny, nx) float) as host numpy.
    """
    _check_mcmr(A)
    n = A.gshape[0]
    g = A.grid
    dev = A.local.device
    if triangular:
        T = A.with_local(A.local.to(_complex_dtype(A.dtype)))
    else:
        T, _Q = schur(A, base=base, nb=nb, precision=precision)
    xs = np.linspace(re_window[0], re_window[1], nx)
    ys = np.linspace(im_window[0], im_window[1], ny)
    Z = xs[None, :] + 1j * ys[:, None]
    all_shifts = Z.reshape(-1)
    k = all_shifts.shape[0]
    rng = np.random.default_rng(seed)
    V0 = rng.normal(size=(n, k)) + 1j * rng.normal(size=(n, k))
    V0 /= np.linalg.norm(V0, axis=0, keepdims=True)
    npdt = np.dtype(str(T.dtype).replace("torch.", ""))
    V = from_global(V0.astype(npdt), MC, MR, grid=g)

    active = np.arange(k)           # global ids of live columns
    ka = k                          # current (padded) batch width
    sh_act = all_shifts.copy()      # length ka, padded with repeats
    est_final = np.zeros(k)
    prev = np.full(k, np.inf)
    quiet = np.zeros(k, dtype=int)      # consecutive quiet checks per shift
    need = max(int(quiet_checks), 1)
    sweep = 0

    def one_sweep(V, shifts_dev, cshifts_dev, width):
        Y = multishift_trsm("U", "N", T, shifts_dev, V, nb=nb,
                            precision=precision)
        ny_ = _global_colnorms(Y, width)
        Yn = diagonal_scale("R", _inverse_scale(ny_, width, T.dtype, g), Y)
        U = multishift_trsm("U", "C", T, cshifts_dev, Yn, nb=nb,
                            precision=precision)
        nu = _global_colnorms(U, width)
        est = torch.sqrt(ny_ * nu)
        return diagonal_scale("R", _inverse_scale(nu, width, T.dtype, g),
                              U), est

    while sweep < iters and active.size:
        shifts_dev = torch.as_tensor(sh_act, device=dev).to(T.dtype)
        cshifts_dev = shifts_dev.conj()
        est = None
        for _ in range(min(check_every, iters - sweep)):
            V, est = one_sweep(V, shifts_dev, cshifts_dev, ka)
            sweep += 1
        estn = est.cpu().numpy()[: active.size]
        est_final[active] = estn
        rel = np.abs(estn - prev[active]) / np.maximum(np.abs(estn), 1e-300)
        prev[active] = estn
        quiet[active] = np.where(rel < tol, quiet[active] + 1, 0)
        conv = quiet[active] >= need
        if snapshot is not None:
            part = np.where(np.isfinite(est_final) & (est_final > 0),
                            1.0 / np.maximum(est_final, 1e-300), 0.0)
            snapshot(sweep, Z, part.reshape(ny, nx))
        if not (deflate and conv.any()) or sweep >= iters:
            if conv.all():
                break
            continue
        keep = np.nonzero(~conv)[0]
        if keep.size == 0:
            break
        active = active[keep]
        # repack live columns first, pad to the next power of two -- but
        # never GROW the batch (next_pow2(keep) can exceed a non-pow2 ka)
        ka2 = min(ka, 1 << max(int(np.ceil(np.log2(max(keep.size, 1)))), 0))
        pad_ids = np.concatenate(
            [keep, np.repeat(keep[:1], ka2 - keep.size)]) \
            if ka2 > keep.size else keep
        Vp = permute_cols(V, torch.as_tensor(
            np.concatenate([pad_ids, np.setdiff1d(np.arange(ka), pad_ids)])
            [:ka], device=dev))
        V = interior_view(Vp, (0, n), (0, ka2)) if ka2 < ka else Vp
        sh_act = sh_act[pad_ids]
        ka = ka2
    estn = est_final
    # exactly-singular shifts drive the solves to inf/0: sigma_min = 0 there
    sigmin = np.where(np.isfinite(estn) & (estn > 0), 1.0 / np.maximum(
        estn, 1e-300), 0.0)
    return Z, sigmin.reshape(ny, nx)
