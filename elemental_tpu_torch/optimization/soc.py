"""Second-order-cone utilities + the SOCP Mehrotra IPM.

PyTorch port of ``elemental_tpu/optimization/soc.py`` (Elemental
``src/optimization/util/SOC/**`` -- ``El::soc``: ``Dets``, ``Apply``,
``Inverse``, ``Sqrt``, ``NesterovTodd``, ``MaxStep``, ``Identity`` -- and
``src/optimization/solvers/SOCP/direct/IPM/Mehrotra.hpp``).

Cone layout (the reference's convention): a member vector stacks K cones;
``orders[i]`` is the length of the cone containing entry i and
``first_inds[i]`` the index of its head, so segment reductions express all
Jordan-algebra ops.  Vectors here are HOST numpy (they are O(n) against
the O(n^2) distributed matrices of the KKT solves), as in the JAX package.

The SOCP solver runs the standard form

    min c^T x  s.t.  A x = b,  x in Q (product of second-order cones)

with Nesterov-Todd scaling and the same host-loop/device-KKT split as
:mod:`.lp`: one dense LDL of the augmented KKT per iteration on the
grid's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.dist import MC, MR
from ..core.distmatrix import DistMatrix, from_global, to_global
from ..redist.interior import interior_update, _blank
from ..blas.level3 import _check_mcmr
from ..lapack.ldl import ldl, ldl_solve_after
from .util import MehrotraCtrl
from .lp import _tp


# ---------------------------------------------------------------------
# Jordan-algebra segment ops (host numpy on replicated member vectors)
# ---------------------------------------------------------------------

def make_cone_layout(orders_list):
    """(orders, first_inds) index vectors from a list of cone sizes."""
    orders, firsts = [], []
    at = 0
    for k in orders_list:
        orders += [k] * k
        firsts += [at] * k
        at += k
    return np.asarray(orders), np.asarray(firsts)


def soc_dets(x, first_inds):
    """det(x) per cone, broadcast to members: x0^2 - ||x1||^2."""
    heads = first_inds == np.arange(x.shape[0])
    tail2 = np.where(heads, 0.0, np.abs(x) ** 2)
    sums = np.bincount(first_inds, weights=np.real(tail2),
                       minlength=x.shape[0])
    head_val = np.real(x[first_inds])
    return head_val ** 2 - sums[first_inds]


def soc_identity(first_inds, n):
    """The cone identity e = (1, 0, ...) per cone."""
    e = np.zeros(n)
    e[np.unique(first_inds)] = 1.0
    return e


def soc_apply(x, y, first_inds):
    """Jordan product (x o y): head = <x, y> per cone; tail =
    x0 y1 + y0 x1."""
    n = x.shape[0]
    heads = first_inds == np.arange(n)
    dots = np.bincount(first_inds, weights=np.real(x * y), minlength=n)
    x0 = x[first_inds]
    y0 = y[first_inds]
    out = x0 * y + y0 * x
    return np.where(heads, dots, out)


def soc_inverse(x, first_inds):
    """Jordan inverse: (x0, -x1)/det(x)."""
    d = soc_dets(x, first_inds)
    heads = first_inds == np.arange(x.shape[0])
    refl = np.where(heads, x, -x)
    return refl / d


def soc_sqrt(x, first_inds):
    """Jordan square root (for interior x)."""
    d = soc_dets(x, first_inds)
    x0 = x[first_inds]
    s = np.sqrt(np.maximum(0.5 * (x0 + np.sqrt(np.maximum(d, 0))), 1e-300))
    heads = first_inds == np.arange(x.shape[0])
    out = np.where(heads, s, x / (2.0 * s))
    return out


def soc_max_step(x, dx, first_inds, cap=1.0):
    """sup {a <= cap : x + a dx in cone} for interior x
    (``soc::MaxStep``): fully segment-vectorized per-cone boundary roots
    of det(x + a dx) = 0 plus the head-positivity crossing."""
    n = x.shape[0]
    heads = first_inds == np.arange(n)
    x0 = x[first_inds]
    dx0 = dx[first_inds]
    xt = np.where(heads, 0.0, x)
    dxt = np.where(heads, 0.0, dx)

    def seg(v):
        return np.bincount(first_inds, weights=v, minlength=n)[first_inds]

    a2 = dx0 ** 2 - seg(dxt * dxt)
    a1 = 2.0 * (x0 * dx0 - seg(xt * dxt))
    a0 = x0 ** 2 - seg(xt * xt)
    big = np.inf
    with np.errstate(all="ignore"):
        disc = a1 * a1 - 4.0 * a2 * a0
        sq = np.sqrt(np.maximum(disc, 0.0))
        r1 = (-a1 - sq) / (2.0 * a2)
        r2 = (-a1 + sq) / (2.0 * a2)
        rlin = -a0 / np.where(a1 == 0, 1.0, a1)
        rhead = -x0 / np.where(dx0 == 0, 1.0, dx0)
    quad = np.abs(a2) > 1e-300
    okq = quad & (disc >= 0)
    cand = np.where(okq & (r1 > 1e-14), r1, big)
    cand = np.minimum(cand, np.where(okq & (r2 > 1e-14), r2, big))
    cand = np.minimum(cand, np.where(~quad & (np.abs(a1) > 1e-300)
                                     & (rlin > 1e-14), rlin, big))
    cand = np.minimum(cand, np.where(dx0 < 0, rhead, big))
    alpha = float(cand[heads].min()) if heads.any() else cap
    return max(min(alpha, cap), 0.0)


def soc_nesterov_todd(x, z, first_inds):
    """The NT scaling point w with Q_w z = x (per cone, closed form)."""
    dx = np.sqrt(np.maximum(soc_dets(x, first_inds), 1e-300))
    dz = np.sqrt(np.maximum(soc_dets(z, first_inds), 1e-300))
    heads = first_inds == np.arange(x.shape[0])
    xb = x / dx
    zb = z / dz
    zb_refl = np.where(heads, zb, -zb)
    # det(xb + J zb) = 2 + 2 xb.zb (PLAIN dot), so this gamma normalizes wb
    gamma_n = np.bincount(first_inds, weights=xb * zb,
                          minlength=x.shape[0])[first_inds]
    gamma = np.sqrt(np.maximum((1.0 + gamma_n) / 2.0, 1e-300))
    wb = (xb + zb_refl) / (2.0 * gamma)
    return wb * np.sqrt(np.maximum(dx / dz, 1e-300))


def _arrow_matrix(w, orders, first_inds):
    """Dense quadratic-representation blocks Q_w (per cone, block diag).

    Q_w = 2 w w^T - det(w) R with R = diag(1, -1, ..., -1); assembled as a
    dense (n, n) block-diagonal host matrix (the KKT scaling block)."""
    n = w.shape[0]
    Q = np.zeros((n, n))
    for h in np.unique(first_inds):
        sel = np.where(first_inds == h)[0]
        wc = w[sel]
        k = len(sel)
        R = np.diag([1.0] + [-1.0] * (k - 1))
        det = wc[0] ** 2 - wc[1:] @ wc[1:]
        Q[np.ix_(sel, sel)] = 2.0 * np.outer(wc, wc) - det * R
    return Q


# ---------------------------------------------------------------------
# SOCP Mehrotra IPM
# ---------------------------------------------------------------------

def socp(A: DistMatrix, b: DistMatrix, c: DistMatrix, orders_list,
         ctrl: MehrotraCtrl | None = None, nb: int | None = None,
         precision=None):
    """Solve min c^T x s.t. A x = b, x in a product of second-order cones
    (``El::SOCP`` direct form).  ``orders_list`` gives the cone sizes
    (summing to n).  Returns (x, y, z, info)."""
    _check_mcmr(A, b, c)
    ctrl = ctrl or MehrotraCtrl()
    m, n = A.gshape
    orders, first_inds = make_cone_layout(orders_list)
    if orders.shape[0] != n:
        raise ValueError(f"cone sizes sum to {orders.shape[0]}, need {n}")
    g = A.grid

    if ctrl.equilibrate:
        # cone-aware Ruiz: the column scale is pooled UNIFORM within each
        # cone (x = Dc x~ then preserves membership); rows of A scale
        # freely.  y = Dr y~, z = Dc^{-1} z~.
        from .equilibrate import row_col_maxabs, _wrap
        from ..blas.level1 import diagonal_scale, diagonal_solve
        dev = g.device
        As = A
        d_r = np.ones(m)
        d_c = np.ones(n)
        starts = np.unique(first_inds)
        for _ in range(4):
            rmax, _cm = row_col_maxabs(As)
            sr = torch.where(rmax > 0, 1.0 / torch.sqrt(
                torch.clamp_min(rmax, 1e-30)), 1.0).cpu().numpy()
            As = diagonal_scale("L", _wrap(torch.as_tensor(
                sr, dtype=A.dtype, device=dev), g), As)
            _rm, cmax = row_col_maxabs(As)
            cmax = cmax.cpu().numpy()
            pooled = np.maximum.reduceat(cmax, starts)[
                np.searchsorted(starts, first_inds)]
            sc = np.where(pooled > 0,
                          1.0 / np.sqrt(np.maximum(pooled, 1e-30)), 1.0)
            As = diagonal_scale("R", _wrap(torch.as_tensor(
                sc, dtype=A.dtype, device=dev), g), As)
            d_r *= sr
            d_c *= sc
        wr = _wrap(torch.as_tensor(d_r, dtype=b.dtype, device=dev), g)
        wc = _wrap(torch.as_tensor(d_c, dtype=c.dtype, device=dev), g)
        bs = diagonal_scale("L", wr, b)
        cs = diagonal_scale("L", wc, c)
        xs, ys, zs, info = socp(As, bs, cs, orders_list,
                                dataclasses.replace(ctrl, equilibrate=False),
                                nb, precision)
        return (diagonal_scale("L", wc, xs), diagonal_scale("L", wr, ys),
                diagonal_solve("L", wc, zs), info)
    At = _tp(A)
    e = soc_identity(first_inds, n)
    K = len(orders_list)

    xv = e.copy()
    zv = e.copy()
    yv = np.zeros(m)
    An = to_global(A).cpu().numpy()
    bn = to_global(b).cpu().numpy().ravel()
    cn = to_global(c).cpu().numpy().ravel()
    nb_ = max(np.linalg.norm(bn), 1.0)
    nc_ = max(np.linalg.norm(cn), 1.0)
    info = {"iters": 0, "converged": False}

    def dmat(M):
        return from_global(M.astype(An.dtype), MC, MR, grid=g)

    best = (np.inf, xv, yv, zv)
    for it in range(ctrl.max_iters):
        rb = An @ xv - bn
        rc = cn - An.T @ yv - zv
        mu = float(xv @ zv) / K
        gap = float(xv @ zv)
        pobj = float(cn @ xv)
        rel_gap = gap / (1.0 + abs(pobj))
        pfeas = np.linalg.norm(rb) / nb_
        dfeas = np.linalg.norm(rc) / nc_
        info.update(iters=it, rel_gap=rel_gap, pfeas=pfeas, dfeas=dfeas,
                    mu=mu, pobj=pobj)
        if ctrl.print_progress:
            print(f"  socp it {it}: gap={rel_gap:.2e} pfeas={pfeas:.2e} "
                  f"dfeas={dfeas:.2e}")
        if rel_gap < ctrl.tol and pfeas < ctrl.tol and dfeas < ctrl.tol:
            info["converged"] = True
            break
        score = max(abs(rel_gap), pfeas, dfeas)
        if not np.isfinite(mu) or rel_gap < 0:
            # boundary breakdown: return the best iterate seen, with info
            # recomputed to describe THAT iterate (not the broken one)
            _, xv, yv, zv = best
            info["stalled"] = True
            gap = float(xv @ zv)
            pobj = float(cn @ xv)
            info.update(mu=gap / K, pobj=pobj,
                        rel_gap=gap / (1.0 + abs(pobj)),
                        pfeas=np.linalg.norm(An @ xv - bn) / nb_,
                        dfeas=np.linalg.norm(cn - An.T @ yv - zv) / nc_)
            break
        if score < best[0]:
            best = (score, xv.copy(), yv.copy(), zv.copy())

        # NT scaling: H = Q_w maps z to x; the Newton system linearizes
        # complementarity as dx + H dz = rcomb, giving the augmented KKT
        #   [ -H^{-1}  A^T ] [dx]   [ rc - H^{-1} rcomb ]
        #   [    A      0  ] [dy] = [       -rb         ]
        # with dz = H^{-1}(rcomb - dx); H^{-1} = Q_{w^-1} in closed form.
        w = soc_nesterov_todd(xv, zv, first_inds)
        winv = soc_inverse(w, first_inds)
        Hinv = _arrow_matrix(winv, orders, first_inds)   # Q_{w^{-1}} = H^{-1}
        Kd = _blank(n + m, n + m, A)
        Kd = interior_update(Kd, dmat(-Hinv), (0, 0))
        Kd = interior_update(Kd, At, (0, n))
        Kd = interior_update(Kd, A, (n, 0))
        Lp, dk, ek, perm = ldl(Kd, conjugate=False, nb=nb,
                               precision=precision)

        def direction(rcomb):
            rhs = np.concatenate([rc - Hinv @ rcomb, -rb])
            sol = ldl_solve_after(Lp, dk, ek, perm,
                                  dmat(rhs.reshape(-1, 1)),
                                  conjugate=False, nb=nb,
                                  precision=precision)
            sflat = to_global(sol).cpu().numpy().ravel()
            dx_, dy_ = sflat[:n], sflat[n:]
            dz_ = Hinv @ (rcomb - dx_)
            return dx_, dy_, dz_

        # predictor (affine): drive x o z toward 0 -> rcomb = -x
        dx_a, dy_a, dz_a = direction(-xv)
        ap = soc_max_step(xv, dx_a, first_inds, cap=1.0)
        ad = soc_max_step(zv, dz_a, first_inds, cap=1.0)
        mu_aff = float((xv + ap * dx_a) @ (zv + ad * dz_a)) / K
        sigma = min(max(mu_aff / mu, 0.0) ** 3, 1.0) if mu > 0 else 0.1
        # corrector: rcomb = -x + sigma mu z^{-1} (Jordan inverse)
        rcomb = -xv + sigma * mu * soc_inverse(zv, first_inds)
        dx_c, dy_c, dz_c = direction(rcomb)
        ap = min(ctrl.eta * soc_max_step(xv, dx_c, first_inds,
                                         cap=1.0 / ctrl.eta), 1.0)
        ad = min(ctrl.eta * soc_max_step(zv, dz_c, first_inds,
                                         cap=1.0 / ctrl.eta), 1.0)
        a = min(ap, ad)
        xv = xv + a * dx_c
        yv = yv + a * dy_c
        zv = zv + a * dz_c
    x = dmat(xv.reshape(-1, 1))
    y = dmat(yv.reshape(-1, 1))
    z = dmat(zv.reshape(-1, 1))
    return x, y, z, info
