"""Affine-form (general conic) Mehrotra IPMs for LP / QP / SOCP.

PyTorch port of ``elemental_tpu/optimization/affine.py`` (Elemental
``src/optimization/solvers/{LP,QP,SOCP}/affine/IPM/Mehrotra.hpp``,
``El::lp::affine::Mehrotra`` et al.): the general form

    min c^T x + (1/2) x^T Q x          (Q = 0 for LP/SOCP)
    s.t.  A x = b,   G x + s = h,   s in K

with K the positive orthant (LP/QP) or a product of second-order cones
(SOCP).  The DIRECT standard forms are the special case G = -I, h = 0 --
this module is the general core the direct solvers conceptually reduce to.

Per iteration (host convergence loop in numpy, device KKT):
assemble the augmented KKT

    [ Q   A^T  G^T ] [dx]   [ -rc             ]
    [ A    0    0  ] [dy] = [ -rb             ]
    [ G    0   -H  ] [dz]   [ -rh + t(r_mu)   ]

where H linearizes the complementarity (pos orth: diag(s/z); SOC: the
Nesterov-Todd quadratic representation W^2 = Q_w), factor ONCE with the
dense distributed LDL on the grid's device, and reuse for the predictor
and corrector solves; recover ds = -rh - G dx from the slack equation.  Ruiz equilibration
(``El::RuizEquil`` on the stacked [A; G] with a shared column scale)
preprocesses badly scaled data -- upstream's mandatory first step --
cone-aware on the G rows for SOCP (uniform scale within each cone).

Cone member vectors are host/replicated (O(m+n+k) against the O(N^2)
distributed KKT, the same subordinate role as in :mod:`.soc`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dist import MC, MR
from ..core.distmatrix import DistMatrix, from_global, to_global
from ..redist.interior import interior_update, _blank
from ..blas.level1 import diagonal_scale
from ..blas.level3 import _check_mcmr
from ..lapack.ldl import ldl, ldl_solve_after
from .util import MehrotraCtrl
from .equilibrate import row_col_maxabs, _wrap
from .soc import (make_cone_layout, soc_identity, soc_apply, soc_inverse,
                  soc_max_step, soc_nesterov_todd, soc_dets, soc_sqrt,
                  _arrow_matrix)


# ---------------------------------------------------------------------
# stacked Ruiz equilibration (shared column scale)
# ---------------------------------------------------------------------

def _pool_rows(v, first_inds):
    """Max-pool a row-scale vector within each cone block: one scale per
    cone keeps scaled members inside the cone."""
    if first_inds is None:
        return v
    starts = np.unique(first_inds)
    cone_max = np.maximum.reduceat(v, starts)
    return cone_max[np.searchsorted(starts, first_inds)]


def _dev(v, like: DistMatrix):
    """A host scale vector as a tensor of ``like``'s dtype on its device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.local.device)


def ruiz_equil_stacked(A: DistMatrix, G: DistMatrix, iters: int = 6,
                       first_inds=None):
    """Ruiz on the stacked [A; G] with one shared column scale: returns
    (A~, G~, d_rA, d_rG, d_c) with A~ = D_rA A D_c, G~ = D_rG G D_c."""
    m, n = A.gshape
    k = G.gshape[0]
    d_rA = np.ones(m)
    d_rG = np.ones(k)
    d_c = np.ones(n)
    As, Gs = A, G
    for _ in range(iters):
        rA, _ = row_col_maxabs(As)
        rG, _ = row_col_maxabs(Gs)
        rA, rG = rA.cpu().numpy(), rG.cpu().numpy()
        rG = _pool_rows(rG, first_inds)
        sA = np.where(rA > 0, 1.0 / np.sqrt(np.maximum(rA, 1e-30)), 1.0)
        sG = np.where(rG > 0, 1.0 / np.sqrt(np.maximum(rG, 1e-30)), 1.0)
        As = diagonal_scale("L", _wrap(_dev(sA, As), A.grid), As)
        Gs = diagonal_scale("L", _wrap(_dev(sG, Gs), A.grid), Gs)
        # column pass AFTER the row scaling (a true Ruiz sweep)
        _, cA = row_col_maxabs(As)
        _, cG = row_col_maxabs(Gs)
        cmax = np.maximum(cA.cpu().numpy(), cG.cpu().numpy())
        sc = np.where(cmax > 0, 1.0 / np.sqrt(np.maximum(cmax, 1e-30)), 1.0)
        As = diagonal_scale("R", _wrap(_dev(sc, As), A.grid), As)
        Gs = diagonal_scale("R", _wrap(_dev(sc, Gs), A.grid), Gs)
        d_rA *= sA
        d_rG *= sG
        d_c *= sc
    return As, Gs, d_rA, d_rG, d_c


# ---------------------------------------------------------------------
# cone operation bundles
# ---------------------------------------------------------------------

class _PosOrth:
    """Positive-orthant cone ops on host vectors (K = R^k_+)."""

    first_inds = None

    def __init__(self, k):
        self.k = k
        self.num_cones = k

    def h_matrix(self, s, z):
        return np.diag(s / np.maximum(z, 1e-300))

    def compl(self, s, z):
        return s * z

    def corrector(self, s, z, ds_a, dz_a, sigma_mu):
        return s * z + ds_a * dz_a - sigma_mu

    def t_vector(self, s, z, r_mu):
        return r_mu / np.maximum(z, 1e-300)

    def max_step(self, v, dv, cap=1.0):
        neg = dv < 0
        ratio = np.where(neg, -v / np.where(neg, dv, -1.0), np.inf)
        return min(float(ratio.min()), cap)

    def mu(self, s, z):
        return float(s @ z) / self.num_cones

    def interior_shift(self, v):
        scale = max(1.0, float(np.abs(v).max()) if v.size else 1.0)
        v = v + max(0.0, -1.5 * float(v.min()))
        if float(v.min()) < 1e-6 * scale:
            v = v + 0.1 * scale
        return v


def _w_apply(u, x, first_inds):
    """Quadratic representation Q_u x = 2 u (u.x)_cone - det(u) R x with
    R = diag(1, -1, ..., -1) per cone.  With u = w^{1/2} this IS the NT
    scaling W x (Q_{w^{1/2}} = Q_w^{1/2} on the second-order cone)."""
    ux = np.bincount(first_inds, weights=u * x,
                     minlength=x.shape[0])[first_inds]
    dets = soc_dets(u, first_inds)
    heads = first_inds == np.arange(x.shape[0])
    Rx = np.where(heads, x, -x)
    return 2.0 * u * ux - dets * Rx


def _jordan_div(u, r, first_inds):
    """Solve u o y = r per cone: the Jordan product's arrow matrix
    L_u = [[u0, ub^T], [ub, u0 I]] inverted in closed form
    (y0 = (u0 r0 - ub.rb)/det(u), yb = (rb - y0 ub)/u0)."""
    n = u.shape[0]
    heads = first_inds == np.arange(n)
    u0 = u[first_inds]
    r0 = r[first_inds]
    dets = soc_dets(u, first_inds)
    dets = np.where(np.abs(dets) < 1e-300, 1e-300, dets)
    ubrb = np.bincount(first_inds, weights=np.where(heads, 0.0, u * r),
                       minlength=n)[first_inds]
    y0 = (u0 * r0 - ubrb) / dets
    u0s = np.where(np.abs(u0) < 1e-300, 1e-300, u0)
    yb = (r - u * y0) / u0s
    return np.where(heads, y0, yb)


class _Soc:
    """Product-of-second-order-cones ops (Nesterov-Todd scaling)."""

    def __init__(self, orders_list):
        self.orders, self.first_inds = make_cone_layout(orders_list)
        self.k = self.orders.shape[0]
        self.num_cones = len(orders_list)

    def h_matrix(self, s, z):
        # w: Q_w z = s; W = Q_{w^{1/2}} satisfies W z = W^{-1} s = lambda
        self._w = soc_nesterov_todd(s, z, self.first_inds)
        self._wh = soc_sqrt(self._w, self.first_inds)
        self._lam = _w_apply(self._wh, z, self.first_inds)
        return _arrow_matrix(self._w, self.orders, self.first_inds)  # W^2

    def compl(self, s, z):
        return soc_apply(self._lam, self._lam, self.first_inds)

    def corrector(self, s, z, ds_a, dz_a, sigma_mu):
        whinv = soc_inverse(self._wh, self.first_inds)
        dss = _w_apply(whinv, ds_a, self.first_inds)     # W^{-1} ds
        dzs = _w_apply(self._wh, dz_a, self.first_inds)  # W dz
        e = soc_identity(self.first_inds, self.k)
        return soc_apply(self._lam, self._lam, self.first_inds) \
            + soc_apply(dss, dzs, self.first_inds) - sigma_mu * e

    def t_vector(self, s, z, r_mu):
        # third-row correction t = W (lambda \ r_mu)
        return _w_apply(self._wh,
                        _jordan_div(self._lam, r_mu, self.first_inds),
                        self.first_inds)

    def max_step(self, v, dv, cap=1.0):
        return float(soc_max_step(v, dv, self.first_inds, cap=cap))

    def mu(self, s, z):
        return float(s @ z) / self.num_cones

    def interior_shift(self, v):
        heads = self.first_inds == np.arange(self.k)
        barb2 = np.bincount(self.first_inds,
                            weights=np.where(heads, 0.0, v * v),
                            minlength=self.k)[self.first_inds]
        margin = float(np.where(heads, v - np.sqrt(barb2), np.inf).min())
        scale = max(1.0, float(np.abs(v).max()) if v.size else 1.0)
        e = soc_identity(self.first_inds, self.k)
        v = v + max(0.0, -1.5 * margin) * e
        if margin < 1e-6 * scale:
            v = v + 0.1 * scale * e
        return v


# ---------------------------------------------------------------------
# the shared affine Mehrotra core
# ---------------------------------------------------------------------

def _host(A: DistMatrix) -> np.ndarray:
    return to_global(A).cpu().numpy()


def _conic_mehrotra(Q, A, G, b, c, h, cone, ctrl, nb, precision,
                    equilibrate=True):
    """Shared core; Q may be None (LP/SOCP) and (A, b) may be None (no
    equality constraints -- CP/TV-style models).  Operands are [MC,MR]
    DistMatrices; returns host vectors (x, y, z, s, info)."""
    if (A is None) != (b is None):
        raise ValueError("A and b must be supplied together (or both None)")
    _check_mcmr(*(X for X in (A, G, b, c, h) if X is not None))
    k, n = G.gshape
    m = A.gshape[0] if A is not None else 0
    g = G.grid

    d_rA = np.ones(m); d_rG = np.ones(k); d_c = np.ones(n)
    if equilibrate:
        if A is not None:
            A, G, d_rA, d_rG, d_c = ruiz_equil_stacked(
                A, G, first_inds=cone.first_inds)
        elif cone.first_inds is None:
            # A-free pos-orth path (CP/TV-style models): plain Ruiz on G
            from .equilibrate import ruiz_equil
            G, d_rG0, d_c0 = ruiz_equil(G)
            d_rG = d_rG0.cpu().numpy()
            d_c = d_c0.cpu().numpy()
        # (A-free SOC problems skip equilibration: pooling G's rows per
        # cone without the stacked column pass buys little)

    An = _host(A) if A is not None else np.zeros((0, n))
    Gn = _host(G)
    bn = (_host(b).ravel() * d_rA) if b is not None else np.zeros(0)
    cn = _host(c).ravel() * d_c
    hn = _host(h).ravel() * d_rG
    Qn = None
    if Q is not None:
        Qn = _host(Q) * d_c[:, None] * d_c[None, :]

    def dmat(M):
        return from_global(np.asarray(M, Gn.dtype), MC, MR, grid=g)

    N = n + m + k

    def kkt_factor(H):
        Kd = _blank(N, N, G)
        if Qn is not None:
            Kd = interior_update(Kd, dmat(Qn), (0, 0))
        if m > 0:
            Kd = interior_update(Kd, dmat(An.T), (0, n))
            Kd = interior_update(Kd, dmat(An), (n, 0))
        Kd = interior_update(Kd, dmat(Gn.T), (0, n + m))
        Kd = interior_update(Kd, dmat(Gn), (n + m, 0))
        Kd = interior_update(Kd, dmat(-H), (n + m, n + m))
        return ldl(Kd, conjugate=False, nb=nb, precision=precision)

    def kkt_solve(fac, r1, r2, r3):
        rhs = np.concatenate([r1, r2, r3]).reshape(-1, 1)
        sol = ldl_solve_after(*fac, dmat(rhs), conjugate=False, nb=nb,
                              precision=precision)
        sf = _host(sol).ravel()
        return sf[:n], sf[n:n + m], sf[n + m:]

    # ---- initialization: two least-norm solves with H = I -------------
    # primal: min ||s|| s.t. Ax=b, Gx+s=h; dual: min ||z|| s.t.
    # A'y + G'z ~= -c (both are this KKT with H=I and the right rhs)
    fac0 = kkt_factor(np.eye(k))
    x, _, _ = kkt_solve(fac0, np.zeros(n), bn, hn)
    s = cone.interior_shift(hn - Gn @ x)
    _, y, z0 = kkt_solve(fac0, -cn, np.zeros(m), np.zeros(k))
    z = cone.interior_shift(z0)

    nb_ = max(np.linalg.norm(bn), 1.0)
    nc_ = max(np.linalg.norm(cn), 1.0)
    nh_ = max(np.linalg.norm(hn), 1.0)
    info = {"iters": 0, "converged": False}
    best = (np.inf, x, y, z, s)

    for it in range(ctrl.max_iters):
        Qx = Qn @ x if Qn is not None else np.zeros(n)
        rb = An @ x - bn
        rh = Gn @ x + s - hn
        rc = Qx + An.T @ y + Gn.T @ z + cn
        mu = cone.mu(s, z)
        pobj = float(cn @ x) + 0.5 * float(x @ Qx)
        dobj = -float(bn @ y) - float(hn @ z) - 0.5 * float(x @ Qx)
        rel_gap = abs(pobj - dobj) / (1.0 + abs(pobj))
        pfeas = max(np.linalg.norm(rb) / nb_, np.linalg.norm(rh) / nh_)
        dfeas = np.linalg.norm(rc) / nc_
        info.update(iters=it, rel_gap=rel_gap, pfeas=pfeas, dfeas=dfeas,
                    mu=mu, pobj=pobj, dobj=dobj)
        if ctrl.print_progress:
            print(f"  affine it {it}: gap={rel_gap:.2e} pfeas={pfeas:.2e} "
                  f"dfeas={dfeas:.2e} mu={mu:.2e}")
        if rel_gap < ctrl.tol and pfeas < ctrl.tol and dfeas < ctrl.tol:
            info["converged"] = True
            break
        score = max(rel_gap, pfeas, dfeas)
        if not np.isfinite(mu) or mu < 0:
            _, x, y, z, s = best
            info["stalled"] = True
            break
        if score < best[0]:
            best = (score, x.copy(), y.copy(), z.copy(), s.copy())

        H = cone.h_matrix(s, z)
        fac = kkt_factor(H)

        def direction(r_mu):
            t = cone.t_vector(s, z, r_mu)
            dx, dy, dz = kkt_solve(fac, -rc, -rb, -rh + t)
            ds = -rh - Gn @ dx
            return dx, dy, dz, ds

        # predictor (affine scaling)
        dx_a, dy_a, dz_a, ds_a = direction(cone.compl(s, z))
        ap = min(cone.max_step(s, ds_a), cone.max_step(z, dz_a))
        mu_aff = cone.mu(s + ap * ds_a, z + ap * dz_a)
        sigma = min(max(mu_aff / mu, 0.0) ** 3, 1.0) if mu > 0 else 0.1

        # corrector (same factorization); eta-damped fraction to the
        # boundary, capped at a full unit step
        r_cor = cone.corrector(s, z, ds_a, dz_a, sigma * mu)
        dx, dy, dz, ds = direction(r_cor)
        ap = min(ctrl.eta * cone.max_step(s, ds, cap=2.0),
                 ctrl.eta * cone.max_step(z, dz, cap=2.0), 1.0)
        x = x + ap * dx
        y = y + ap * dy
        z = z + ap * dz
        s = s + ap * ds

    # undo equilibration: x = D_c x~, y = D_rA y~, z = D_rG z~, s = s~/d_rG
    return (x * d_c, y * d_rA, z * d_rG, s / d_rG, info)


# ---------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------

def lp_affine(A: DistMatrix, G: DistMatrix, b: DistMatrix, c: DistMatrix,
              h: DistMatrix, ctrl: MehrotraCtrl | None = None,
              nb: int | None = None, precision=None,
              equilibrate: bool = True):
    """Affine-form LP (``El::lp::affine::Mehrotra``):
    min c'x s.t. Ax=b, Gx+s=h, s >= 0.  Returns (x, y, z, s, info)."""
    ctrl = ctrl or MehrotraCtrl()
    cone = _PosOrth(G.gshape[0])
    return _conic_mehrotra(None, A, G, b, c, h, cone, ctrl, nb, precision,
                           equilibrate)


def qp_affine(Q: DistMatrix, A: DistMatrix, G: DistMatrix, b: DistMatrix,
              c: DistMatrix, h: DistMatrix,
              ctrl: MehrotraCtrl | None = None, nb: int | None = None,
              precision=None, equilibrate: bool = True):
    """Affine-form QP (``El::qp::affine::Mehrotra``):
    min (1/2)x'Qx + c'x s.t. Ax=b, Gx+s=h, s >= 0."""
    ctrl = ctrl or MehrotraCtrl()
    cone = _PosOrth(G.gshape[0])
    return _conic_mehrotra(Q, A, G, b, c, h, cone, ctrl, nb, precision,
                           equilibrate)


def socp_affine(A: DistMatrix, G: DistMatrix, b: DistMatrix, c: DistMatrix,
                h: DistMatrix, orders_list,
                ctrl: MehrotraCtrl | None = None, nb: int | None = None,
                precision=None, equilibrate: bool = True):
    """Affine-form SOCP (``El::socp::affine::Mehrotra``):
    min c'x s.t. Ax=b, Gx+s=h, s in a product of second-order cones."""
    ctrl = ctrl or MehrotraCtrl()
    if sum(orders_list) != G.gshape[0]:
        raise ValueError(f"cone sizes sum to {sum(orders_list)}, "
                         f"G has {G.gshape[0]} rows")
    cone = _Soc(orders_list)
    return _conic_mehrotra(None, A, G, b, c, h, cone, ctrl, nb, precision,
                           equilibrate)
