"""Dense Mehrotra predictor-corrector QP interior-point solver.

PyTorch port of ``elemental_tpu/optimization/qp.py`` (Elemental
``src/optimization/solvers/QP/direct/IPM/Mehrotra.hpp``,
``El::qp::direct::Mehrotra``, ``AUGMENTED_KKT``):

    min 1/2 x^T Q x + c^T x  s.t.  A x = b,  x >= 0

Each iteration solves the symmetric-indefinite augmented KKT system

    [ -(Q + X^{-1} Z)   A^T ] [ dx ]   [ rd - X^{-1} r_mu ]
    [       A            0  ] [ dy ] = [      -rp         ]

with the Bunch-Kaufman LDL from :mod:`..lapack.ldl`, one factorization
per iteration reused by predictor and corrector.  With no equality
constraints (``A is None``) the system collapses to the HPD
``(Q + X^{-1} Z) dx = rhs`` and Cholesky is used (through the
``potrf_inv`` kernel on the card) -- the NNLS/Lasso engine.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.distmatrix import DistMatrix
from ..redist.interior import interior_view, interior_update, vstack, _blank
from ..blas.level1 import _valid_mask, update_diagonal, shift_diagonal
from ..blas.level3 import _check_mcmr, gemm
from ..lapack.cholesky import cholesky, cholesky_solve_after
from ..lapack.ldl import ldl, ldl_solve_after
from .util import MehrotraCtrl, max_step, safe_div
from .lp import _tp, _dot, _norm, _wrap_diag


def qp(Q: DistMatrix, c: DistMatrix, A: DistMatrix | None = None,
       b: DistMatrix | None = None, ctrl: MehrotraCtrl | None = None,
       nb: int | None = None, precision=None):
    """Solve the standard-form convex QP; returns (x, y, z, info)."""
    _check_mcmr(Q, c)
    if (A is None) != (b is None):
        raise ValueError("A and b must be supplied together")
    ctrl = ctrl or MehrotraCtrl()
    n = Q.gshape[0]
    m = A.gshape[0] if A is not None else 0
    g = Q.grid

    if ctrl.equilibrate:
        # symmetric Ruiz on Q fixes the column scale Dc (Q~ = Dc Q Dc,
        # preserving symmetry/PSD); A gets the shared Dc plus its own row
        # scale.  x = Dc x~, y = Dr y~, z = Dc^{-1} z~.
        from .equilibrate import symmetric_ruiz_equil, row_col_maxabs, _wrap
        from ..blas.level1 import diagonal_scale, diagonal_solve
        Qs, d_c = symmetric_ruiz_equil(Q)
        wc = _wrap(d_c.to(c.dtype), g)
        cs = diagonal_scale("L", wc, c)
        ctrl2 = dataclasses.replace(ctrl, equilibrate=False)
        if A is None:
            xs, ys, zs, info = qp(Qs, cs, None, None, ctrl2, nb, precision)
            return (diagonal_scale("L", wc, xs), ys,
                    diagonal_solve("L", wc, zs), info)
        As = diagonal_scale("R", wc, A)
        rmax, _ = row_col_maxabs(As)
        d_r = torch.where(rmax > 0,
                          1.0 / torch.sqrt(torch.clamp_min(rmax, 1e-30)), 1.0)
        wr = _wrap(d_r.to(b.dtype), g)
        As = diagonal_scale("L", wr, As)
        bs = diagonal_scale("L", wr, b)
        xs, ys, zs, info = qp(Qs, cs, As, bs, ctrl2, nb, precision)
        return (diagonal_scale("L", wc, xs), diagonal_scale("L", wr, ys),
                diagonal_solve("L", wc, zs), info)

    At = _tp(A) if A is not None else None
    vm_x = _valid_mask(c)
    vm_xf = vm_x.to(c.dtype)

    # simple interior start
    x = c.with_local(vm_xf)
    z = c.with_local(vm_xf)
    y = b.with_local(torch.zeros_like(b.local)) if b is not None else None

    nb_ = max(_norm(b), 1.0) if b is not None else 1.0
    nc_ = max(_norm(c), 1.0)
    info = {"iters": 0, "converged": False, "rel_gap": np.inf}

    prev = (x, y, z)
    for it in range(ctrl.max_iters):
        Qx = gemm(Q, x, nb=nb, precision=precision)
        rd = c.with_local(Qx.local + c.local - z.local
                          - (gemm(At, y, nb=nb, precision=precision).local
                             if A is not None else 0))
        rp = (b.with_local(gemm(A, x, nb=nb, precision=precision).local
                           - b.local) if A is not None else None)
        mu = _dot(x, z) / n
        if not np.isfinite(mu):
            x, y, z = prev
            info["stalled"] = True
            break
        prev = (x, y, z)
        pobj = 0.5 * _dot(x, Qx) + _dot(c, x)
        gap_abs = _dot(x, z)
        rel_gap = gap_abs / (1.0 + abs(pobj))
        pfeas = (_norm(rp) / nb_) if rp is not None else 0.0
        dfeas = _norm(rd) / nc_
        info.update(iters=it, rel_gap=rel_gap, pfeas=pfeas, dfeas=dfeas,
                    mu=mu, pobj=pobj)
        if ctrl.print_progress:
            print(f"  qp it {it}: gap={rel_gap:.2e} pfeas={pfeas:.2e} "
                  f"dfeas={dfeas:.2e}")
        if rel_gap < ctrl.tol and pfeas < ctrl.tol and dfeas < ctrl.tol:
            info["converged"] = True
            break

        dinv2 = x.with_local(safe_div(z.local, x.local))    # X^{-1} Z
        H = update_diagonal(Q, _wrap_diag(dinv2))           # Q + X^{-1}Z
        # static regularization (dense reg_ldl analog; see lp.normal_solve)
        H = shift_diagonal(H, 1e-12 * (1.0 + float(torch.max(
            torch.abs(H.local)))))

        if A is None:
            Lfac = cholesky(H, "L", nb=nb, precision=precision)

            def solve_dir(r_mu, _):
                xinv_rmu = safe_div(r_mu, x.local)
                rhs = c.with_local(-rd.local + xinv_rmu)
                dxv = cholesky_solve_after(Lfac, rhs, nb=nb,
                                           precision=precision)
                dzv = x.with_local(safe_div(r_mu - z.local * dxv.local,
                                            x.local))
                return dxv, None, dzv, Lfac
            fac = None
        else:
            K = _blank(n + m, n + m, Q)
            K = interior_update(K, H.with_local(-H.local), (0, 0))
            K = interior_update(K, At, (0, n))
            K = interior_update(K, A, (n, 0))
            Lp, dK, eK, permK = ldl(K, conjugate=False, nb=nb,
                                    precision=precision)
            fac = (Lp, dK, eK, permK)

            def solve_dir(r_mu, fac):
                Lp, dK, eK, permK = fac
                xinv_rmu = safe_div(r_mu, x.local)
                r1 = c.with_local(rd.local - xinv_rmu)
                r2 = rp.with_local(-rp.local)
                rhs = vstack(r1, r2)
                sol = ldl_solve_after(Lp, dK, eK, permK, rhs,
                                      conjugate=False, nb=nb,
                                      precision=precision)
                dxv = interior_view(sol, (0, n), (0, 1))
                dyv = interior_view(sol, (n, n + m), (0, 1))
                dzv = x.with_local(safe_div(r_mu - z.local * dxv.local,
                                            x.local))
                return dxv, dyv, dzv, fac

        r_aff = -(x.local * z.local)
        dx_a, dy_a, dz_a, fac = solve_dir(r_aff, fac)
        ap = float(max_step(x, dx_a))
        ad = float(max_step(z, dz_a))
        mu_aff = float(torch.sum((x.local + ap * dx_a.local)
                                 * (z.local + ad * dz_a.local))) / n
        sigma = min((mu_aff / mu) ** 3, 1.0) if mu > 0 else 0.1
        r_cor = sigma * mu * vm_xf - x.local * z.local \
            - dx_a.local * dz_a.local
        dx_c, dy_c, dz_c, _ = solve_dir(r_cor, fac)
        ap = min(ctrl.eta * float(max_step(x, dx_c, cap=1.0 / ctrl.eta)), 1.0)
        ad = min(ctrl.eta * float(max_step(z, dz_c, cap=1.0 / ctrl.eta)), 1.0)
        a = min(ap, ad)      # QP couples x and (y,z) through Q: common step
        x = x.with_local(x.local + a * dx_c.local)
        if y is not None:
            y = y.with_local(y.local + a * dy_c.local)
        z = z.with_local(z.local + a * dz_c.local)
    return x, y, z, info
