"""Sparse-operand Mehrotra LP + sparse LAV/BP models.

PyTorch port of ``elemental_tpu/optimization/sparse_ipm.py`` (the sparse
instantiations of the upstream IPMs,
``src/optimization/solvers/LP/direct/IPM/Mehrotra.hpp`` over
``DistSparseMatrix``, whose KKT engine is the sparse-direct multifrontal
``reg_ldl`` + FGMRES refinement).

As in the JAX package, the per-iteration normal system

    (A D^2 A^T + reg I) dy = rhs,   D^2 = diag(x / z)

is solved either by scipy's ``splu`` on host triplets (``kkt='direct'``)
or MATRIX-FREE by Jacobi-preconditioned CG on the SpMV operator
(``kkt='cg'``), with outer iterative refinement.  The Jacobi diagonal
diag(A D^2 A^T) costs one SpMV of the squared-value matrix against d^2
per iteration.  Ruiz equilibration preprocesses the triplets host-side.

The CG solve (:func:`_pcg_device`) is the JAX package's one-call
``lax.while_loop`` recast for the card: a fixed chunk of
:data:`PCG_CHUNK` MASKED iterations (an iteration after the loop's
condition turns false changes nothing, so the count and the iterate are
the while loop's), captured once as a CUDA graph and replayed until the
device flag says done -- one host read a chunk instead of ~6 launches
and 3 blocking reads an iteration.  On the CPU the same chunk runs
eagerly.  Only the Mehrotra outer loop runs on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.multivec import (DistMultiVec, mv_axpy, mv_dot, mv_from_global,
                             mv_nrm2, mv_to_global)
from ..sparse.core import DistSparseMatrix, dist_sparse_from_coo
from .util import MehrotraCtrl


# ---------------------------------------------------------------------
# triplet helpers
# ---------------------------------------------------------------------

# re-exported for back-compat; the helper lives with its type now
from ..sparse.core import sparse_to_coo  # noqa: E402,F401


def sparse_ruiz_equil(rows, cols, vals, m, n, iters: int = 6):
    """Host-side Ruiz on COO triplets: returns (vals_scaled, d_r, d_c)."""
    d_r = np.ones(m)
    d_c = np.ones(n)
    v = np.asarray(vals, np.float64).copy()
    for _ in range(iters):
        rmax = np.zeros(m)
        np.maximum.at(rmax, rows, np.abs(v))
        sr = np.where(rmax > 0, 1.0 / np.sqrt(np.maximum(rmax, 1e-30)), 1.0)
        v *= sr[rows]
        cmax = np.zeros(n)
        np.maximum.at(cmax, cols, np.abs(v))
        sc = np.where(cmax > 0, 1.0 / np.sqrt(np.maximum(cmax, 1e-30)), 1.0)
        v *= sc[cols]
        d_r *= sr
        d_c *= sc
    return v, d_r, d_c


# ---------------------------------------------------------------------
# matrix-free preconditioned CG (the reg_ldl-solve stand-in)
# ---------------------------------------------------------------------

#: masked CG iterations a captured graph runs between two host reads
PCG_CHUNK = 32

#: the CG solves' counters: ``solves``, ``iters`` (the loop's own
#: count), ``chunks`` (graph replays on the card, eager chunks on the
#: CPU), ``reads`` (host reads of the done flag), ``captures``
PCG_COUNTS = {"solves": 0, "iters": 0, "chunks": 0, "reads": 0,
              "captures": 0}


def _emul(X: DistMultiVec, Y: DistMultiVec) -> DistMultiVec:
    return X.with_local(X.local * Y.local)


class _PcgState:
    """The tensors one masked CG chunk reads and writes: the inputs
    (``d2``, ``dinv``, ``reg``, ``tol``), the loop state (``x``, ``r``,
    ``p``, ``rz``, ``it``, ``ok``), ``bnorm`` and the ``live`` flag the
    host reads after each chunk."""

    def __init__(self, b: DistMultiVec, d2: DistMultiVec,
                 dinv: DistMultiVec):
        z = torch.zeros((), dtype=b.dtype, device=b.local.device)
        rdt = z.real.dtype
        self.meta, self.d2_meta = b, d2
        self.d2 = d2.local.clone()
        self.dinv = dinv.local.clone()
        self.reg = torch.zeros((), dtype=rdt, device=z.device)
        self.tol = torch.zeros((), dtype=rdt, device=z.device)
        self.x = torch.zeros_like(b.local)
        self.r = torch.zeros_like(b.local)
        self.p = torch.zeros_like(b.local)
        self.rz = torch.zeros((), dtype=rdt, device=z.device)
        self.bnorm = torch.zeros((), dtype=rdt, device=z.device)
        self.it = torch.zeros((), dtype=torch.int64, device=z.device)
        self.ok = torch.ones((), dtype=torch.bool, device=z.device)
        self.live = torch.ones((), dtype=torch.bool, device=z.device)

    def load(self, d2, reg, b, dinv, tol) -> None:
        """The JAX loop's initial state, written into the tensors."""
        self.d2.copy_(d2.local)
        self.dinv.copy_(dinv.local)
        self.reg.fill_(reg)
        self.tol.fill_(tol)
        z0 = self.dinv * b.local
        self.x.zero_()
        self.r.copy_(b.local)
        self.p.copy_(z0)
        self.rz.copy_(torch.real(mv_dot(b, b.with_local(z0))))
        self.bnorm.copy_(torch.clamp_min(mv_nrm2(b), 1e-300))
        self.it.zero_()
        self.ok.fill_(True)
        self.live.fill_(True)


def _pcg_chunk(A: DistSparseMatrix, st: _PcgState, maxiter: int,
               steps: int) -> None:
    """``steps`` masked iterations of the JAX ``body`` in place on ``st``
    (each iteration first evaluates the JAX ``cond``; when it is false
    the iteration writes back the state it read), then ``st.live`` =
    ``cond`` of the final state.  No host read: this is what the graph
    captures."""
    d2 = st.d2_meta.with_local(st.d2)
    dinv = st.meta.with_local(st.dinv)

    def vec(t):
        return st.meta.with_local(t)

    def cond(r):
        return st.ok & (st.it < maxiter) & (mv_nrm2(r) / st.bnorm >= st.tol)

    for _ in range(steps):
        x, r, p = vec(st.x), vec(st.r), vec(st.p)
        live = cond(r)
        t = A.spmv_adjoint(p)
        Ap = mv_axpy(st.reg, p, A.spmv(_emul(d2, t)))
        denom = torch.real(mv_dot(p, Ap))
        pd = denom > 0
        alpha = torch.where(pd, st.rz / torch.where(pd, denom, 1.0), 0.0)
        x = mv_axpy(alpha, p, x)
        r = mv_axpy(-alpha, Ap, r)
        zv = _emul(dinv, r)
        rz_new = torch.real(mv_dot(r, zv))
        beta = rz_new / torch.where(st.rz != 0, st.rz, 1.0)
        p = mv_axpy(beta, p, zv)
        st.x.copy_(torch.where(live, x.local, st.x))
        st.r.copy_(torch.where(live, r.local, st.r))
        st.p.copy_(torch.where(live, p.local, st.p))
        st.rz.copy_(torch.where(live, rz_new, st.rz))
        st.ok.copy_(torch.where(live, pd, st.ok))
        st.it.add_(live.to(torch.int64))
    st.live.copy_(cond(vec(st.r)))


def _run_chunks(st: _PcgState, chunk) -> None:
    """Run ``chunk()`` until the ``live`` flag reads false: one host read
    a chunk."""
    PCG_COUNTS["solves"] += 1
    while True:
        chunk()
        PCG_COUNTS["chunks"] += 1
        PCG_COUNTS["reads"] += 1
        if not bool(st.live):
            break
    PCG_COUNTS["iters"] += int(st.it)


def _pcg_eager(A: DistSparseMatrix, d2: DistMultiVec, reg,
               b: DistMultiVec, dinv: DistMultiVec, tol, maxiter: int,
               chunk: int = PCG_CHUNK):
    """The masked chunks run eagerly (the CPU's path; on the card the
    reference the graph replay is held to)."""
    st = _PcgState(b, d2, dinv)
    st.load(d2, reg, b, dinv, tol)
    _run_chunks(st, lambda: _pcg_chunk(A, st, maxiter, chunk))
    return b.with_local(st.x), st.it


def _pcg_graph(A: DistSparseMatrix, d2: DistMultiVec, reg,
               b: DistMultiVec, dinv: DistMultiVec, tol, maxiter: int,
               graphs: dict | None = None):
    """The masked chunk as one captured CUDA graph, replayed until the
    ``live`` flag it writes reads false (one host read a replay).

    The graph reads ``A``'s ``vals``, ``cols`` and segment-sum plans and
    the :class:`_PcgState` tensors (``d2``, ``dinv``, ``reg``, ``tol``,
    ``bnorm`` and the loop state), and writes the loop state and
    ``live``; each call copies its inputs into that state.  ``graphs``
    is the caller's cache, (A, shape, dtype, maxiter) -> (graph, state,
    A), so ``lp_sparse`` captures once per call and frees the graph when
    it returns (``None``: a cache for this call only)."""
    graphs = {} if graphs is None else graphs
    key = (id(A), tuple(b.local.shape), b.dtype, maxiter)
    entry = graphs.get(key)
    if entry is None or entry[2] is not A:
        st = _PcgState(b, d2, dinv)
        st.load(d2, reg, b, dinv, tol)
        dev = b.local.device
        # one eager chunk on a side stream builds the plans and warms the
        # libraries the capture uses
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _pcg_chunk(A, st, maxiter, 1)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _pcg_chunk(A, st, maxiter, PCG_CHUNK)
        PCG_COUNTS["captures"] += 1
        entry = (graph, st, A)
        graphs[key] = entry
    graph, st, _ = entry
    st.load(d2, reg, b, dinv, tol)
    _run_chunks(st, graph.replay)
    return b.with_local(st.x.clone()), st.it.clone()


def _pcg_device(A: DistSparseMatrix, d2: DistMultiVec, reg,
                b: DistMultiVec, dinv: DistMultiVec, tol, maxiter: int,
                graphs: dict | None = None):
    """Jacobi-preconditioned CG on the regularized normal operator
    w -> A D^2 A' w + reg w: :func:`_pcg_graph` on the card,
    :func:`_pcg_eager` on the CPU.  Returns (w, it) with ``it`` a 0-d
    tensor, the JAX loop's iteration count."""
    if b.local.is_cuda:
        return _pcg_graph(A, d2, reg, b, dinv, tol, maxiter, graphs)
    return _pcg_eager(A, d2, reg, b, dinv, tol, maxiter)


# ---------------------------------------------------------------------
# sparse Mehrotra LP
# ---------------------------------------------------------------------

def lp_sparse(A: DistSparseMatrix, b: DistMultiVec, c: DistMultiVec,
              ctrl: MehrotraCtrl | None = None, cg_tol: float = 1e-10,
              cg_maxiter: int | None = None, refine: int = 1,
              kkt: str = "auto"):
    """Standard-form LP over a DistSparseMatrix: min c'x st Ax=b, x >= 0.

    Returns (x, y, z, info) as DistMultiVecs.  ``kkt`` picks the normal-
    equation engine (the ``reg_ldl`` role -- see module docstring):

      * 'direct' -- SEQUENTIAL sparse-direct factorization of
        A D^2 A' + reg (scipy splu on host triplets, refactored per
        iteration).  The analog of the reference's sequential sparse
        path (``El::SparseMatrix`` + ``ldl``); robust at high
        conditioning, where Krylov iteration counts blow up as
        ~1/sqrt(mu).  The distributed-multifrontal numeric factor is
        the upgrade path.
      * 'cg' -- matrix-free Jacobi-preconditioned CG (no host
        factorization; fine at moderate accuracy/conditioning); on the
        card one captured graph of masked chunks, held for this call.
      * 'auto' -- 'direct' when scipy is importable and m is moderate
        (robustness first, as upstream always factors); 'cg' otherwise.
        NOTE the trade: 'direct' gathers triplets to the host and its
        fill depends on structure (banded/separator graphs are cheap;
        random-expander patterns fill catastrophically -- for those,
        neither engine is good, which is the fundamental reason the
        reference bundles ParMETIS orderings).
    """
    ctrl = ctrl or MehrotraCtrl()
    m, n = A.gshape
    g = A.grid
    if b.gshape[0] != m or c.gshape[0] != n:
        raise ValueError(f"shape mismatch: A {A.gshape}, b {b.gshape}, "
                         f"c {c.gshape}")
    cg_maxiter = cg_maxiter or 4 * m
    if kkt not in ("auto", "direct", "cg"):
        raise ValueError(f"kkt must be 'auto', 'direct' or 'cg', got {kkt!r}")
    if kkt == "auto":
        try:
            import scipy.sparse  # noqa: F401
            kkt = "direct" if m <= 200_000 else "cg"
        except ImportError:
            kkt = "cg"

    d_r = np.ones(m)
    d_c = np.ones(n)
    if ctrl.equilibrate:
        ro, co, vo = sparse_to_coo(A)
        vs, d_r, d_c = sparse_ruiz_equil(ro, co, vo, m, n)
        A = dist_sparse_from_coo(ro, co, vs, m, n, grid=g,
                                 dtype=np.asarray(vo).dtype)
        b = b.with_local(b.local * _col(_pad_host(d_r, b.local.shape[0]),
                                        b))
        c = c.with_local(c.local * _col(_pad_host(d_c, c.local.shape[0]),
                                        c))

    A2 = A.with_values(A.vals * A.vals)          # |A|^2 for Jacobi diagonals
    vm_x = _valid(n, c)                          # row-validity masks
    vm_y = _valid(m, b)
    graphs: dict = {}                 # the CG graph, held for this call
    if kkt == "direct":
        import scipy.sparse as _sp
        ro2, co2, vo2 = sparse_to_coo(A)
        _Acsr = _sp.csr_matrix((np.asarray(vo2, np.float64),
                                (ro2, co2)), shape=(m, n))

    def esafe(xl, zl):
        return torch.where(zl != 0, xl / torch.where(zl == 0, 1, zl), 0)

    def engine_data(d2: DistMultiVec):
        """Per-IPM-iteration solver data (normal_solve runs 4x on the
        same D^2: predictor + corrector, each with a refinement pass).

        'direct': assemble A E A' + reg on host triplets and splu-factor
        (the reg_ldl refactor step).  'cg': Jacobi diagonal + reg."""
        if kkt == "direct":
            import scipy.sparse.linalg as _spl
            e = mv_to_global(d2).cpu().numpy().ravel()
            M = (_Acsr.multiply(e[None, :])) @ _Acsr.T
            reg = 1e-10 * (1.0 + float(abs(M.diagonal()).max()))
            M = (M + reg * _sp.eye(m, format="csr")).tocsc()
            return reg, _spl.splu(M)
        diag = A2.spmv(d2)
        reg = 1e-10 * (1.0 + float(torch.max(diag.local)))
        diag = diag.with_local(diag.local + reg * vm_y[:, None])
        return reg, diag.with_local(esafe(vm_y[:, None], diag.local))

    def normal_solve(d2: DistMultiVec, rhs: DistMultiVec, tol, jd=None):
        """(A D2 A' + reg) w = rhs by the selected engine + iterative
        refinement against the true (device-side) operator."""
        reg, fac = jd if jd is not None else engine_data(d2)

        def op(w):
            t = A.spmv_adjoint(w)
            return mv_axpy(reg, w, A.spmv(_emul(d2, t)))

        if kkt == "direct":
            rh = mv_to_global(rhs).cpu().numpy().ravel()
            w = mv_from_global(fac.solve(rh).reshape(-1, 1), grid=g)
            it = 1                      # factor-solve counts as one pass
            for _ in range(refine):
                r = mv_axpy(-1.0, op(w), rhs)
                if float(mv_nrm2(r)) / max(float(mv_nrm2(rhs)),
                                           1e-300) < tol:
                    break
                dr = mv_to_global(r).cpu().numpy().ravel()
                w = mv_axpy(1.0, mv_from_global(
                    fac.solve(dr).reshape(-1, 1), grid=g), w)
                it += 1
            return w, it
        w, it = _pcg_device(A, d2, reg, rhs, fac, tol, cg_maxiter, graphs)
        it = int(it)
        for _ in range(refine):
            r = mv_axpy(-1.0, op(w), rhs)
            if float(mv_nrm2(r)) / max(float(mv_nrm2(rhs)), 1e-300) < tol:
                break
            dw, it2 = _pcg_device(A, d2, reg, r, fac, tol, cg_maxiter,
                                  graphs)
            w = mv_axpy(1.0, dw, w)
            it += int(it2)
        return w, it

    # ---- Mehrotra initialization (least-norm via A A') ----------------
    ones = c.with_local(vm_x[:, None].to(c.dtype))
    jd0 = engine_data(ones)          # one factorization for both solves
    w0, _ = normal_solve(ones, b, cg_tol, jd=jd0)
    x = A.spmv_adjoint(w0)
    yrhs = A.spmv(c)
    y, _ = normal_solve(ones, yrhs, cg_tol, jd=jd0)
    z = c.with_local(c.local - A.spmv_adjoint(y).local)
    xl, zl = x.local, z.local
    dx = max(0.0, -1.5 * float(torch.min(torch.where(vm_x[:, None] > 0, xl,
                                                     torch.inf))))
    dz = max(0.0, -1.5 * float(torch.min(torch.where(vm_x[:, None] > 0, zl,
                                                     torch.inf))))
    xl = torch.where(vm_x[:, None] > 0, xl + dx, 0)
    zl = torch.where(vm_x[:, None] > 0, zl + dz, 0)
    xz = float(torch.sum(xl * zl))
    ex = 0.5 * xz / max(float(torch.sum(zl)), 1e-30)
    ez = 0.5 * xz / max(float(torch.sum(xl)), 1e-30)
    x = x.with_local(torch.where(vm_x[:, None] > 0, xl + ex, 0))
    z = z.with_local(torch.where(vm_x[:, None] > 0, zl + ez, 0))

    nb_ = max(float(mv_nrm2(b)), 1.0)
    nc_ = max(float(mv_nrm2(c)), 1.0)
    info = {"iters": 0, "converged": False, "rel_gap": np.inf,
            "cg_iters": 0}
    prev = (x, y, z)
    best = (np.inf, x, y, z, {})
    stall = 0

    for it in range(ctrl.max_iters):
        rb = mv_axpy(-1.0, A.spmv(x), b)
        rc = c.with_local(c.local - A.spmv_adjoint(y).local - z.local)
        mu = float(torch.real(mv_dot(x, z))) / n
        if not np.isfinite(mu):
            x, y, z = prev
            info["stalled"] = True
            break
        prev = (x, y, z)
        pobj = float(torch.real(mv_dot(c, x)))
        dobj = float(torch.real(mv_dot(b, y)))
        rel_gap = abs(pobj - dobj) / (1.0 + abs(pobj))
        pfeas = float(mv_nrm2(rb)) / nb_
        dfeas = float(mv_nrm2(rc)) / nc_
        info.update(iters=it, rel_gap=rel_gap, pfeas=pfeas, dfeas=dfeas,
                    mu=mu, pobj=pobj, dobj=dobj)
        if ctrl.print_progress:
            print(f"  lp_sparse it {it}: gap={rel_gap:.2e} "
                  f"pfeas={pfeas:.2e} dfeas={dfeas:.2e} mu={mu:.2e} "
                  f"cg={info['cg_iters']}")
        if rel_gap < ctrl.tol and pfeas < ctrl.tol and dfeas < ctrl.tol:
            info["converged"] = True
            break
        # once mu underflows, D^2 = x/z spans ~1/mu and the Krylov normal
        # solve degrades into oscillation: keep the best iterate and stop
        # when no progress is made for several rounds
        score = max(rel_gap, pfeas, dfeas)
        if score < best[0]:
            best = (score, x, y, z,
                    dict(iters=it, rel_gap=rel_gap, pfeas=pfeas,
                         dfeas=dfeas, mu=mu, pobj=pobj, dobj=dobj))
            stall = 0
        else:
            stall += 1
        if stall >= 6 or mu < 1e-16:
            _, x, y, z, snap = best
            info.update(snap)
            info["converged"] = best[0] < ctrl.tol
            info["stalled"] = not info["converged"]
            break

        d2 = x.with_local(esafe(x.local, z.local))
        jd_it = engine_data(d2)
        # inexact-Newton forcing: solve the normal system just accurately
        # enough for the current mu (tightens as the iterates converge)
        tol_it = max(cg_tol, min(1e-6, 1e-2 * mu))

        def solve_core(rc_l, rb_mv, rmu_l):
            """One elimination pass for the KKT system
            A'dy + dz = rc, A dx = rb, z dx + x dz = rmu
            (targets as passed -- the dense lp.py sign convention)."""
            zinv_rmu = x.with_local(esafe(rmu_l, z.local))
            t = x.with_local(d2.local * rc_l - zinv_rmu.local)
            rhs = mv_axpy(1.0, A.spmv(t), rb_mv)
            dy, cg_it = normal_solve(d2, rhs, tol_it, jd=jd_it)
            info["cg_iters"] += cg_it
            Atdy = A.spmv_adjoint(dy)
            dxv = x.with_local(d2.local * (Atdy.local - rc_l)
                               + zinv_rmu.local)
            dzv = x.with_local(esafe(rmu_l - z.local * dxv.local, x.local))
            return dxv, dy, dzv

        def solve_dir(r_mu):
            # solve_core targets: A dx = rb, A'dy + dz = rc, z dx + x dz
            # = r_mu (the dense lp.py convention)
            dxv, dy, dzv = solve_core(rc.local, rb, r_mu)
            # KKT-level iterative refinement (the reg_ldl::
            # RegularizedSolveAfter role): the dx recovery amplifies the
            # inner normal-solve error by ||D^2||, so one correction pass
            # on the TRUE KKT residuals recovers full direction accuracy.
            e1 = rc.local - (A.spmv_adjoint(dy).local + dzv.local)
            e2 = mv_axpy(-1.0, A.spmv(dxv), rb)          # rb - A dx
            e3 = r_mu - (z.local * dxv.local + x.local * dzv.local)
            ex, ey, ez = solve_core(e1, e2, e3)
            return (x.with_local(dxv.local + ex.local),
                    mv_axpy(1.0, ey, dy),
                    x.with_local(dzv.local + ez.local))

        r_aff = -(x.local * z.local)
        dx_a, dy_a, dz_a = solve_dir(r_aff)
        ap = _max_step(x, dx_a)
        ad = _max_step(z, dz_a)
        mu_aff = float(torch.sum((x.local + ap * dx_a.local)
                                 * (z.local + ad * dz_a.local))) / n
        sigma = min(max(mu_aff / mu, 0.0) ** 3, 1.0) if mu > 0 else 0.1

        r_cor = sigma * mu * vm_x[:, None] - x.local * z.local \
            - dx_a.local * dz_a.local
        dx_c, dy_c, dz_c = solve_dir(r_cor)
        ap = min(ctrl.eta * _max_step(x, dx_c, cap=2.0), 1.0)
        ad = min(ctrl.eta * _max_step(z, dz_c, cap=2.0), 1.0)
        x = mv_axpy(ap, dx_c, x)
        y = mv_axpy(ad, dy_c, y)
        z = mv_axpy(ad, dz_c, z)

    if ctrl.equilibrate:
        x = x.with_local(x.local * _col(_pad_host(d_c, x.local.shape[0]), x))
        y = y.with_local(y.local * _col(_pad_host(d_r, y.local.shape[0]), y))
        dcp = _pad_host(d_c, z.local.shape[0])
        dcp = np.where(dcp == 0, 1.0, dcp)
        z = z.with_local(z.local / _col(dcp, z))
    return x, y, z, info


def _pad_host(v, rows):
    out = np.zeros(rows, v.dtype)
    out[: v.shape[0]] = v
    return out


def _col(v, like: DistMultiVec):
    """A host vector as an (n, 1) tensor of ``like``'s dtype on its
    device."""
    return torch.as_tensor(v, device=like.local.device)[:, None].to(
        like.dtype)


def _valid(k, template: DistMultiVec):
    rows = template.local.shape[0]
    return (torch.arange(rows, device=template.local.device) < k).to(
        template.dtype)


def _max_step(v: DistMultiVec, dv: DistMultiVec, cap: float = 1.0):
    neg = dv.local < 0
    ratio = torch.where(neg, -v.local / torch.where(neg, dv.local, -1.0),
                        torch.inf)
    return min(float(torch.min(ratio)), cap)


# ---------------------------------------------------------------------
# sparse models: LAV and BP (the upstream LP-reduction models over
# DistSparseMatrix operands -- src/optimization/models/{LAV,BP}.cpp)
# ---------------------------------------------------------------------

def lav_sparse(A: DistSparseMatrix, b: DistMultiVec,
               ctrl: MehrotraCtrl | None = None, **kw):
    """Least absolute value regression min ||Ax - b||_1 (``El::LAV``
    sparse): LP on [x+; x-; u; v] >= 0 with [A, -A, I, -I] equality
    rows.  Returns (x, info)."""
    m, n = A.gshape
    g = A.grid
    ro, co, vo = sparse_to_coo(A)
    rows = np.concatenate([ro, ro, np.arange(m), np.arange(m)])
    cols = np.concatenate([co, co + n,
                           2 * n + np.arange(m), 2 * n + m + np.arange(m)])
    vals = np.concatenate([vo, -vo, np.ones(m), -np.ones(m)])
    N = 2 * n + 2 * m
    Ah = dist_sparse_from_coo(rows, cols, vals, m, N, grid=g,
                              dtype=vo.dtype)
    ch = mv_from_global(np.concatenate([np.zeros(2 * n), np.ones(2 * m)])
                        .reshape(-1, 1).astype(vo.dtype), grid=g)
    xh, yh, zh, info = lp_sparse(Ah, b, ch, ctrl, **kw)
    xg = mv_to_global(xh).cpu().numpy().ravel()
    x = mv_from_global((xg[:n] - xg[n:2 * n]).reshape(-1, 1)
                       .astype(vo.dtype), grid=g)
    return x, info


def bp_sparse(A: DistSparseMatrix, b: DistMultiVec,
              ctrl: MehrotraCtrl | None = None, **kw):
    """Basis pursuit min ||x||_1 s.t. Ax = b (``El::BP`` sparse): LP on
    [x+; x-] >= 0 with [A, -A] equality rows.  Returns (x, info)."""
    m, n = A.gshape
    g = A.grid
    ro, co, vo = sparse_to_coo(A)
    rows = np.concatenate([ro, ro])
    cols = np.concatenate([co, co + n])
    vals = np.concatenate([vo, -vo])
    Ah = dist_sparse_from_coo(rows, cols, vals, m, 2 * n, grid=g,
                              dtype=vo.dtype)
    ch = mv_from_global(np.ones((2 * n, 1), vo.dtype), grid=g)
    xh, yh, zh, info = lp_sparse(Ah, b, ch, ctrl, **kw)
    xg = mv_to_global(xh).cpu().numpy().ravel()
    x = mv_from_global((xg[:n] - xg[n:]).reshape(-1, 1)
                       .astype(vo.dtype), grid=g)
    return x, info
