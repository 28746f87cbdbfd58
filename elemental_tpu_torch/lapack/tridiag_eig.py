"""Cuppen divide-and-conquer symmetric tridiagonal eigensolver.

PyTorch port of ``elemental_tpu/lapack/tridiag_eig.py`` (the JAX
package's replacement for the reference's bundled PMRRR, driven from
``src/lapack_like/spectral/HermitianEig.cpp``): LAPACK ``dstedc``'s
algorithm, whose O(n^3) work is eigenvector matmuls and whose O(n^2)
secular-equation work vectorizes over the roots.

The design is the JAX package's: static shapes with no dynamic deflation
(pole gaps enforced to >= 8 eps * scale, rank-one weights floored at
2 eps), mu-anchored bisection with a Newton polish, Gu-Eisenstat
reconstruction of the weights, and two phases -- subproblems of size
<= ``repl_max`` merged replicated and batched over the subproblem axis,
larger merges on a block-diagonal [MC,MR] ``DistMatrix`` with the
secular eigenvector matrix filled tile-locally and the half-height
updates as SUMMA ``gemm`` (``alg='dot'``).

Port choices:

* ``jax.vmap`` over the merges of one level becomes a leading batch
  dimension on every tensor of :func:`_secular`, :func:`_merge_replicated`
  and :func:`_merge_rows_only` (one set of launches a level, not one a
  merge); the eigenvector fill is ``torch.vmap`` of :func:`_v_entries`.
* The secular stage runs in float64 always, with 62 bisection steps, on
  the CPU and on the card: the configuration the JAX package runs in
  under ``jax_enable_x64``, where its tests run.  The O(n^3) eigenvector
  products stay in the storage dtype.
* ``jnp.argsort`` is stable, so ``torch.argsort(..., stable=True)``;
  ``lax.associative_scan(jnp.maximum)`` is ``torch.cummax``.
* The driver runs eagerly (the JAX package jits it whole).
"""
from __future__ import annotations

import math

import torch

from ..core.dist import MC, MR, STAR
from ..core.distmatrix import DistMatrix, zeros as dm_zeros
from ..redist.engine import redistribute
from ..redist.interior import interior_view, interior_update
from ..blas.level1 import index_dependent_fill
from ..blas.level3 import gemm

#: dtype of the secular stage (see the module docstring)
_SDT = torch.float64
_N_ITERS = 62


# ---------------------------------------------------------------------
# secular equation: all roots of a batch of merges in parallel
# ---------------------------------------------------------------------

def _enforce_gaps(ds, eta):
    """Monotone perturbation along the last dim: ds_i <- max over j<=i of
    (ds_j + (i-j)*eta), so ds_{i+1} - ds_i >= eta, each entry moving by at
    most (#violations)*eta."""
    n = ds.shape[-1]
    i = torch.arange(n, dtype=ds.dtype, device=ds.device)
    u = torch.cummax(ds - i * eta, dim=-1).values
    return u + i * eta


def _take(x, idx):
    """``x[b, idx[b, ...]]`` along the last dim, per batch row."""
    return torch.take_along_dim(x, idx, dim=-1)


def _secular(D, z, beta, scale, n_iters: int, chunk: int):
    """Solve eig(D + beta z z^T) for a batch: D, z (b, n), beta (b,).

    Returns (lam, perm, ds, tau, aidx, zhat, cninv, flip), each with the
    leading batch dim:
      lam   -- eigenvalues ascending, (b, n)
      perm  -- stable argsort of the (possibly negated) pole vector
      ds    -- gap-enforced sorted poles (core domain)
      tau   -- lam_core[i] - ds[aidx[i]]: signed offset from the closer
               interval endpoint (the dlaed4 anchoring)
      aidx  -- anchor index per root (i or i+1)
      zhat  -- Gu-Eisenstat weights in core row order
      cninv -- 1/||column i||
      flip  -- (b,) True where beta < 0: final column c = core column
               n-1-c, final lam = -reverse(core lam)
    all in the secular dtype."""
    sdt = _SDT
    dev = D.device
    fi = torch.finfo(sdt)
    eps = fi.eps
    scale = torch.as_tensor(scale, dtype=sdt, device=dev)
    tfloor = 4 * math.sqrt(fi.tiny) * torch.clamp(scale, min=1.0)
    D = D.to(sdt)
    z = z.to(sdt)
    beta = torch.as_tensor(beta, dtype=sdt, device=dev)
    n = D.shape[-1]

    flip = beta < 0
    rho = torch.maximum(beta.abs(), 16 * eps * scale)
    Dw = torch.where(flip[:, None], -D, D)
    perm = torch.argsort(Dw, dim=-1, stable=True)
    ds = _enforce_gaps(_take(Dw, perm), 8 * eps * scale)
    zp = _take(z, perm)
    sgn = torch.where(zp >= 0, 1.0, -1.0).to(sdt)
    # |z| floored at 2 eps: every secular pole stays present (no 0/0 in
    # the eigenvector fill) at an eps * ||T|| backward error
    zs = sgn * torch.clamp(zp.abs(), min=2 * eps)
    z2 = zs * zs
    zn2 = z2.sum(-1)

    # interval upper widths: gap to the next pole; the last root lies in
    # (ds[n-1], ds[n-1] + rho*||z||^2)
    gaps = torch.cat([ds[:, 1:] - ds[:, :-1],
                      (rho * zn2 * (1 + 4 * eps) + eps * scale)[:, None]], -1)
    rho_ = rho[:, None]
    z2_ = z2[:, None, :]

    def solve_chunk(s, width):
        idx = s + torch.arange(width, device=dev)
        half = 0.5 * gaps[:, s:s + width]
        # anchor choice (dlaed4): f at the interval midpoint; f < 0 puts the
        # root in the upper half -- anchor at the upper pole, solve for tau
        # in (-gap/2, 0).  The last root always anchors low.
        diff_lo = ds[:, None, :] - ds[:, s:s + width, None]     # d_j - d_i
        fmid = 1.0 + rho_ * (z2_ / (diff_lo - half[:, :, None])).sum(-1)
        upper = (fmid < 0) & (idx < n - 1)
        aidx = idx + upper.to(idx.dtype)
        diff = ds[:, None, :] - _take(ds, aidx)[:, :, None]    # d_j - d_anchor
        lo = torch.where(upper, -half, 0.0)
        hi = torch.where(upper, 0.0, half)
        for _ in range(n_iters):
            mid = 0.5 * (lo + hi)
            f = 1.0 + rho_ * (z2_ / (diff - mid[:, :, None])).sum(-1)
            neg = f < 0
            lo = torch.where(neg, mid, lo)
            hi = torch.where(neg, hi, mid)
        tau = 0.5 * (lo + hi)
        # Newton polish clamped to the bracket: relative accuracy for roots
        # tiny compared to their interval
        for _ in range(2):
            den = diff - tau[:, :, None]
            f = 1.0 + rho_ * (z2_ / den).sum(-1)
            fp = rho_ * (z2_ / (den * den)).sum(-1)
            t_new = tau - f / fp
            tau = torch.where((t_new > lo) & (t_new < hi), t_new, tau)
        # keep tau strictly off the anchor pole (else 0/0 downstream)
        tau = torch.where(upper, torch.minimum(tau, -tfloor),
                          torch.maximum(tau, tfloor))
        return tau, aidx

    c = min(chunk, n)
    parts = [solve_chunk(s, min(c, n - s)) for s in range(0, n, c)]
    tau = torch.cat([p[0] for p in parts], -1)
    aidx = torch.cat([p[1] for p in parts], -1)
    ds_a = _take(ds, aidx)
    off = (ds_a - ds) + tau            # lam_i - ds[i]  (in (0, gap_i))

    # Gu-Eisenstat: zhat_k^2 = prod_i (lam_i - d_k) / (rho prod_{i!=k}
    # (d_i - d_k)), paired per i as log1p(off_i/(d_i - d_k)) so partial sums
    # stay O(1).  Exact special cases: i == k contributes log(off_k);
    # k == aidx_i (upper-anchored neighbour) contributes log(-tau_i) -
    # log(gap_i), since lam_i - d_k = tau_i exactly.
    k_idx = torch.arange(n, device=dev)
    acc = torch.zeros_like(ds)
    gap_anchor = ds_a - ds                     # gap_i for upper roots, 0 else
    for s in range(0, n, c):
        w = min(c, n - s)
        i_idx = s + torch.arange(w, device=dev)
        diff_ki = ds[:, None, s:s + w] - ds[:, :, None]      # d_i - d_k
        offi = off[:, None, s:s + w]
        is_diag = (k_idx[:, None] == i_idx[None, :])[None]
        is_anchor = (k_idx[None, :, None] == aidx[:, None, s:s + w]) & ~is_diag
        safe = torch.where(is_diag | is_anchor, 1.0, diff_ki)
        generic = torch.log1p(offi / safe)
        anchor_term = (torch.log(-tau[:, s:s + w])
                       - torch.log(gap_anchor[:, s:s + w]))[:, None, :]
        diag_term = torch.log(off[:, s:s + w])[:, None, :]
        pair = torch.where(is_diag, diag_term,
                           torch.where(is_anchor, anchor_term, generic))
        acc = acc + pair.sum(-1)
    zhat = sgn * torch.exp(0.5 * (acc - torch.log(rho)[:, None]))
    zh2 = zhat * zhat
    nrm = torch.empty_like(ds)                 # column norms^2, core order
    for s in range(0, n, c):
        w = min(c, n - s)
        denom = (ds[:, :, None] - ds_a[:, None, s:s + w]) \
            - tau[:, None, s:s + w]
        nrm[:, s:s + w] = (zh2[:, :, None] / (denom * denom)).sum(1)
    cninv = 1.0 / torch.sqrt(nrm)

    lam_core = ds + off
    lam = torch.where(flip[:, None], -lam_core.flip(-1), lam_core)
    return lam, perm, ds, tau, aidx, zhat, cninv, flip


def _v_entries(row_pos, col_pos, perm, ds, tau, aidx, zhat, cninv, flip,
               out_dtype):
    """V[row_pos, col_pos] of ONE merge's secular eigenvector matrix in
    the original row basis and final (ascending-lam) column order, from
    the 1-D core quantities of :func:`_secular` (batch row 0).  Shapes
    broadcast: row_pos (..., 1), col_pos (1, ...)."""
    n = perm.shape[0]
    invperm = torch.argsort(perm)
    k = invperm[row_pos.clamp(0, n - 1)]               # core row of orig row
    cp = col_pos.clamp(0, n - 1)
    col = torch.where(flip, n - 1 - cp, cp)
    denom = (ds[k] - ds[aidx[col]]) - tau[col]         # d_k - lam_col, exact
    return (zhat[k] / denom * cninv[col]).to(out_dtype)


def _v_batch(perm, ds, tau, aidx, zhat, cninv, flip, out_dtype):
    """The whole (b, n, n) secular eigenvector matrices of a batch:
    :func:`_v_entries` mapped over the batch dimension."""
    n = perm.shape[-1]
    dev = perm.device
    rows = torch.arange(n, device=dev)[:, None]
    cols = torch.arange(n, device=dev)[None, :]
    return torch.vmap(_v_entries, in_dims=(None, None) + (0,) * 7 + (None,))(
        rows, cols, perm, ds, tau, aidx, zhat, cninv, flip, out_dtype)


# ---------------------------------------------------------------------
# replicated batched phase
# ---------------------------------------------------------------------

def _merge_replicated(lam1, lam2, Q1, Q2, beta, scale, n_iters, chunk):
    """A batch of merges on replicated data: returns (lam_new, Q_new) with
    Q_new = blockdiag(Q1, Q2) @ V per batch entry."""
    nm = lam1.shape[-1]
    D = torch.cat([lam1, lam2], -1)
    z = torch.cat([Q1[:, -1, :], Q2[:, 0, :]], -1)
    lam, perm, ds, tau, aidx, zhat, cninv, flip = _secular(
        D, z, beta, scale, n_iters, chunk)
    V = _v_batch(perm, ds, tau, aidx, zhat, cninv, flip, Q1.dtype)
    top = torch.bmm(Q1, V[:, :nm, :])
    bot = torch.bmm(Q2, V[:, nm:, :])
    return lam.to(lam1.dtype), torch.cat([top, bot], 1)


def _merge_rows_only(lam1, lam2, fr1, lr1, fr2, lr2, beta, scale, n_iters,
                     chunk):
    """Eigenvalue-only merges: carry just the first and last rows of the
    eigenvector matrix (enough to form the next level's z), O(nm^2) work,
    O(nm) state."""
    D = torch.cat([lam1, lam2], -1)
    z = torch.cat([lr1, fr2], -1)
    lam, perm, ds, tau, aidx, zhat, cninv, flip = _secular(
        D, z, beta, scale, n_iters, chunk)
    V = _v_batch(perm, ds, tau, aidx, zhat, cninv, flip, fr1.dtype)
    fr = torch.bmm(torch.cat([fr1, torch.zeros_like(fr2)], -1)[:, None, :], V)
    lr = torch.bmm(torch.cat([torch.zeros_like(lr1), lr2], -1)[:, None, :], V)
    return lam.to(lam1.dtype), fr[:, 0], lr[:, 0]


# ---------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------

def _plan(n: int, leaf_max: int):
    """(base, levels): npad = base * 2^levels >= n with base in
    (leaf_max/2, leaf_max] so padding never exceeds 2^levels entries."""
    if n <= leaf_max:
        return n, 0
    L = max(0, math.ceil(math.log2(n / leaf_max)))
    base = math.ceil(n / (1 << L))
    return base, L


def _leaf_eigh(d_adj, e_leaf, base: int, B: int):
    """Batched dense EVP of the (B, base, base) leaf blocks; ``e_leaf`` is
    (B, base) with per-leaf interior couplings in columns [0, base-1)."""
    dmat = torch.diag_embed(d_adj.reshape(B, base))
    if base > 1:
        eb = e_leaf[:, :-1]
        idx = torch.arange(base - 1, device=d_adj.device)
        dmat[:, idx + 1, idx] += eb
        dmat[:, idx, idx + 1] += eb
    return torch.linalg.eigh(dmat)


def tridiag_eig(d, e, grid=None, vectors: bool = True,
                leaf_max: int = 96, repl_max: int = 512,
                chunk: int = 1024, precision=None):
    """Eigendecomposition of the symmetric tridiagonal T = tridiag(e, d, e).

    Returns ascending ``w`` (replicated, cast to d's dtype, at least
    float32) and, when ``vectors``, the eigenvector matrix as an [MC,MR]
    ``DistMatrix`` over ``grid`` (a replicated tensor if ``grid`` is
    None).  Above ``repl_max`` no replicated n x n array is formed.
    ``d`` and ``e`` are tensors (or arrays) on the device to work on;
    ``precision`` is accepted for the JAX signature (the port's matmuls
    are full precision)."""
    dev = grid.device if grid is not None else (
        d.device if isinstance(d, torch.Tensor) else torch.device("cuda", 0))
    d = torch.as_tensor(d, device=dev)
    e = torch.as_tensor(e, device=dev)
    sdt = _SDT
    n = d.shape[0]
    odt = torch.promote_types(d.dtype, torch.float32)
    d = d.to(sdt)
    e = e.to(sdt)
    n_iters = _N_ITERS
    scale = d.abs().max() + 2 * e.abs().max() if n > 1 else d[0].abs() + 1.0
    scale = scale + 1e-30

    base, L = _plan(n, leaf_max)
    npad = base << L
    # decoupled sentinel diagonals ABOVE the spectrum pad to npad: they
    # sort to the tail and slice off exactly
    sent = scale * (3.0 + torch.arange(npad - n, dtype=sdt, device=dev))
    dp = torch.cat([d, sent])
    ep = torch.cat([e, torch.zeros(npad - n, dtype=sdt, device=dev)])

    # pre-apply every split's rank-one diagonal correction: at each interior
    # leaf boundary k (multiple of base), d[k-1] -= e[k-1], d[k] -= e[k-1]
    nblk = npad // base
    bidx = base * torch.arange(1, nblk, device=dev)
    beta_all = ep[bidx - 1]
    d_adj = dp.clone()
    d_adj[bidx - 1] -= beta_all
    d_adj[bidx] -= beta_all
    # leaf-interior e, laid out (B, base): column base-1 unused
    e_leaf = torch.cat([ep, torch.zeros(1, dtype=sdt, device=dev)]
                       ).reshape(nblk, base)

    lam, Q = _leaf_eigh(d_adj, e_leaf, base, nblk)
    if vectors:
        Q = Q.to(odt)        # O(n^3) matmul work runs in the storage dtype

    # ---- replicated batched phase ------------------------------------
    B, nm = nblk, base
    if not vectors:
        fr, lr = Q[:, 0, :], Q[:, -1, :]
    while B > 1 and 2 * nm <= max(repl_max, 2 * base):
        betas = ep[torch.arange(B // 2, device=dev) * 2 * nm + nm - 1]
        if vectors:
            lam, Q = _merge_replicated(lam[0::2], lam[1::2], Q[0::2],
                                       Q[1::2], betas, scale, n_iters, chunk)
        else:
            lam, fr, lr = _merge_rows_only(lam[0::2], lam[1::2], fr[0::2],
                                           lr[0::2], fr[1::2], lr[1::2],
                                           betas, scale, n_iters, chunk)
        B //= 2
        nm *= 2

    if not vectors:
        while B > 1:
            betas = ep[torch.arange(B // 2, device=dev) * 2 * nm + nm - 1]
            lam, fr, lr = _merge_rows_only(lam[0::2], lam[1::2], fr[0::2],
                                           lr[0::2], fr[1::2], lr[1::2],
                                           betas, scale, n_iters, chunk)
            B //= 2
            nm *= 2
        return lam[0][:n].to(odt)

    if B == 1:
        w, Z = lam[0][:n].to(odt), Q[0][:n, :n]
        if grid is None:
            return w, Z
        Zd = redistribute(DistMatrix(Z, (n, n), STAR, STAR, 0, 0, grid),
                          MC, MR)
        return w, Zd

    # ---- distributed phase -------------------------------------------
    if grid is None:
        raise ValueError("tridiag_eig: n exceeds repl_max and no grid given")
    # the block-diagonal DistMatrix of the (B, nm, nm) batch
    Qb = Q

    def qfill(i, j):
        bi, ri = i // nm, i % nm
        bj, cj = j // nm, j % nm
        val = Qb[bi.clamp(0, B - 1), ri, cj]
        return torch.where(bi == bj, val, 0.0).to(odt)

    Qd = index_dependent_fill(dm_zeros(npad, npad, MC, MR, grid, dtype=odt),
                              qfill)
    del Q, Qb
    lam_full = lam.reshape(-1)

    while B > 1:
        for p in range(B // 2):
            o = p * 2 * nm
            beta = ep[o + nm - 1]
            Q1 = interior_view(Qd, (o, o + nm), (o, o + nm))
            Q2 = interior_view(Qd, (o + nm, o + 2 * nm), (o + nm, o + 2 * nm))
            z1 = redistribute(interior_view(Q1, (nm - 1, nm), (0, nm)),
                              STAR, STAR).local[0]
            z2 = redistribute(interior_view(Q2, (0, 1), (0, nm)),
                              STAR, STAR).local[0]
            D = lam_full[o:o + 2 * nm]
            z = torch.cat([z1, z2]).to(sdt)
            lamn, perm, ds, tau, aidx, zhat, cninv, flip = (
                x[0] for x in _secular(D[None], z[None], beta[None], scale,
                                       n_iters, chunk))

            def vfill(i, j, _p=perm, _ds=ds, _tau=tau, _ai=aidx, _zh=zhat,
                      _cn=cninv, _fl=flip):
                return _v_entries(i, j, _p, _ds, _tau, _ai, _zh, _cn, _fl,
                                  odt)

            V = index_dependent_fill(
                dm_zeros(2 * nm, 2 * nm, MC, MR, grid, dtype=odt), vfill)
            Vtop = interior_view(V, (0, nm), (0, 2 * nm))
            Vbot = interior_view(V, (nm, 2 * nm), (0, 2 * nm))
            del V
            Ztop = gemm(Q1, Vtop, alg="dot")
            Zbot = gemm(Q2, Vbot, alg="dot")
            del Q1, Q2, Vtop, Vbot
            Qd = interior_update(Qd, Ztop, (o, o))
            Qd = interior_update(Qd, Zbot, (o + nm, o))
            lam_full = lam_full.clone()
            lam_full[o:o + 2 * nm] = lamn
        B //= 2
        nm *= 2

    w = lam_full[:n].to(odt)
    return w, interior_view(Qd, (0, n), (0, n))
