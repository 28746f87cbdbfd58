"""Dense Mehrotra predictor-corrector LP interior-point solver.

PyTorch port of ``elemental_tpu/optimization/lp.py`` (Elemental
``src/optimization/solvers/LP/direct/IPM/Mehrotra.hpp``,
``El::lp::direct::Mehrotra``, ``KKTSystem = NORMAL_KKT`` dense path):

    min c^T x  s.t.  A x = b,  x >= 0        (primal, standard form)
    max b^T y  s.t.  A^T y + z = c, z >= 0   (dual)

The convergence loop runs on the HOST; each iteration is device work --
one Cholesky factorization of the normal matrix M = A D^2 A^T (D^2 =
diag(x/z)) reused by the predictor and corrector solves (on the card its
diagonal blocks go through the ``potrf_inv`` kernel, ceil(m / nb) a
factorization), plus matmul-shaped residual/step algebra on [MC,MR]
storage.  The host reads the same scalars in the same order as the JAX
package (the gap, the norms, the step lengths), so the iterate sequence
is the same one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.dist import MC, MR, STAR
from ..core.distmatrix import DistMatrix, to_global
from ..redist.engine import redistribute, transpose_dist
from ..blas.level1 import (_valid_mask, shift_diagonal, diagonal_scale,
                           diagonal_solve)
from ..blas.level3 import _check_mcmr, gemm
from ..lapack.cholesky import cholesky, cholesky_solve_after
from .util import MehrotraCtrl, max_step, safe_div


def _tp(A):
    return redistribute(transpose_dist(A), MC, MR)


def _dot(a: DistMatrix, b: DistMatrix) -> float:
    return float(torch.sum(a.local * b.local))


def _norm(a: DistMatrix) -> float:
    return float(torch.linalg.vector_norm(a.local))


def _wrap_diag(v: DistMatrix) -> DistMatrix:
    """(n,1) [MC,MR] vector -> replicated (n,1) diagonal for diagonal_scale."""
    return DistMatrix(to_global(v), v.gshape, STAR, STAR, 0, 0, v.grid)


def lp(A: DistMatrix, b: DistMatrix, c: DistMatrix,
       ctrl: MehrotraCtrl | None = None, nb: int | None = None,
       precision=None):
    """Solve the standard-form LP; returns (x, y, z, info dict)."""
    _check_mcmr(A, b, c)
    ctrl = ctrl or MehrotraCtrl()
    m, n = A.gshape
    g = A.grid

    if ctrl.equilibrate:
        # Ruiz first (El::RuizEquil): A~ = Dr A Dc, b~ = Dr b, c~ = Dc c;
        # solve scaled, then x = Dc x~, y = Dr y~, z = Dc^{-1} z~.
        from .equilibrate import ruiz_equil, _wrap
        As, d_r, d_c = ruiz_equil(A)
        wr = _wrap(d_r.to(b.dtype), g)
        wc = _wrap(d_c.to(c.dtype), g)
        bs = diagonal_scale("L", wr, b)
        cs = diagonal_scale("L", wc, c)
        xs, ys, zs, info = lp(As, bs, cs,
                              dataclasses.replace(ctrl, equilibrate=False),
                              nb, precision)
        x = diagonal_scale("L", wc, xs)
        y = diagonal_scale("L", wr, ys)
        z = diagonal_solve("L", wc, zs)
        return x, y, z, info

    At = _tp(A)
    vm_x = _valid_mask(c)
    vm_xf = vm_x.to(c.dtype)

    def normal_solve(d2, rhs, Lfac=None):
        """Solve (A D2 A^T + reg I) w = rhs; returns (w, L) reusing Lfac.

        The static diagonal regularization is the dense analog of the
        reference's ``reg_ldl`` (``El::reg_ldl::RegularizedSolveAfter``):
        it keeps the normal matrix factorable as the iterates approach a
        degenerate face (D^2 dynamic range blows up near convergence)."""
        if Lfac is None:
            Ad = diagonal_scale("R", _wrap_diag(d2), A)
            M = gemm(Ad, At, nb=nb, precision=precision)
            M = M.with_local(0.5 * (M.local + redistribute(
                transpose_dist(M), MC, MR).local))
            reg = 1e-12 * (1.0 + float(torch.max(torch.abs(M.local))))
            M = shift_diagonal(M, reg)
            Lfac = cholesky(M, "L", nb=nb, precision=precision)
        w = cholesky_solve_after(Lfac, rhs, nb=nb, precision=precision)
        return w, Lfac

    # ---- Mehrotra initialization -------------------------------------
    ones = c.with_local(vm_xf)
    w0, L0 = normal_solve(ones, b)                       # (A A^T) w = b
    x = gemm(At, w0, nb=nb, precision=precision)         # least-norm primal
    yrhs = gemm(A, c, nb=nb, precision=precision)
    y, _ = normal_solve(ones, yrhs, L0)                  # (A A^T) y = A c
    z = c.with_local(c.local - gemm(At, y, nb=nb, precision=precision).local)
    dx = max(0.0, -1.5 * float(torch.min(torch.where(vm_x, x.local,
                                                     torch.inf))))
    dz = max(0.0, -1.5 * float(torch.min(torch.where(vm_x, z.local,
                                                     torch.inf))))
    xs = x.with_local(torch.where(vm_x, x.local + dx, 0))
    zs = z.with_local(torch.where(vm_x, z.local + dz, 0))
    xz = _dot(xs, zs)
    ex = 0.5 * xz / max(float(torch.sum(zs.local)), 1e-30)
    ez = 0.5 * xz / max(float(torch.sum(xs.local)), 1e-30)
    x = xs.with_local(torch.where(vm_x, xs.local + ex, 0))
    z = zs.with_local(torch.where(vm_x, zs.local + ez, 0))

    nb_ = max(_norm(b), 1.0)
    nc_ = max(_norm(c), 1.0)
    info = {"iters": 0, "converged": False, "rel_gap": np.inf}

    prev = (x, y, z)
    for it in range(ctrl.max_iters):
        rb = b.with_local(b.local - gemm(A, x, nb=nb, precision=precision).local)
        rc = c.with_local(c.local
                          - gemm(At, y, nb=nb, precision=precision).local
                          - z.local)
        mu = _dot(x, z) / n
        if not np.isfinite(mu):
            # numerically singular normal system at a degenerate face:
            # keep the last good iterate (already near-optimal in practice)
            x, y, z = prev
            info["stalled"] = True
            break
        prev = (x, y, z)
        pobj = _dot(c, x)
        dobj = _dot(b, y)
        rel_gap = abs(pobj - dobj) / (1.0 + abs(pobj))
        pfeas = _norm(rb) / nb_
        dfeas = _norm(rc) / nc_
        info.update(iters=it, rel_gap=rel_gap, pfeas=pfeas, dfeas=dfeas,
                    mu=mu, pobj=pobj, dobj=dobj)
        if ctrl.print_progress:
            print(f"  lp it {it}: gap={rel_gap:.2e} pfeas={pfeas:.2e} "
                  f"dfeas={dfeas:.2e} mu={mu:.2e}")
        if rel_gap < ctrl.tol and pfeas < ctrl.tol and dfeas < ctrl.tol:
            info["converged"] = True
            break

        d2 = x.with_local(safe_div(x.local, z.local))

        def solve_dir(r_mu, Lfac):
            # A D2 A^T dy = rb + A (D2 rc - Z^{-1} r_mu)
            zinv_rmu = x.with_local(safe_div(r_mu, z.local))
            t = x.with_local(d2.local * rc.local - zinv_rmu.local)
            rhs = b.with_local(rb.local
                               + gemm(A, t, nb=nb, precision=precision).local)
            dy, Lfac = normal_solve(d2, rhs, Lfac)
            Atdy = gemm(At, dy, nb=nb, precision=precision)
            dxv = x.with_local(d2.local * (Atdy.local - rc.local)
                               + zinv_rmu.local)
            dzv = x.with_local(safe_div(r_mu - z.local * dxv.local, x.local))
            return dxv, dy, dzv, Lfac

        # predictor (affine scaling)
        r_aff = -(x.local * z.local)
        dx_a, dy_a, dz_a, Lfac = solve_dir(r_aff, None)
        ap = float(max_step(x, dx_a))
        ad = float(max_step(z, dz_a))
        mu_aff = float(torch.sum((x.local + ap * dx_a.local)
                                 * (z.local + ad * dz_a.local))) / n
        sigma = min((mu_aff / mu) ** 3, 1.0) if mu > 0 else 0.1

        # corrector (centering + second order), same factorization
        r_cor = sigma * mu * vm_xf - x.local * z.local \
            - dx_a.local * dz_a.local
        dx_c, dy_c, dz_c, _ = solve_dir(r_cor, Lfac)
        ap = ctrl.eta * float(max_step(x, dx_c, cap=1.0 / ctrl.eta))
        ad = ctrl.eta * float(max_step(z, dz_c, cap=1.0 / ctrl.eta))
        ap, ad = min(ap, 1.0), min(ad, 1.0)
        x = x.with_local(x.local + ap * dx_c.local)
        y = y.with_local(y.local + ad * dy_c.local)
        z = z.with_local(z.local + ad * dz_c.local)
    return x, y, z, info
