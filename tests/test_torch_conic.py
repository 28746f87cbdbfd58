"""The port's conic IPMs (``optimization/soc.py``, ``affine.py``) against
``elemental_tpu``, on the inputs of ``tests/optimization/test_solvers.py``
and ``test_affine.py`` (made from the same seeds with numpy).

* the second-order-cone algebra (host numpy in both packages) gives the
  same bits;
* ``socp``, ``lp_affine``, ``qp_affine`` and ``socp_affine`` stopped after
  k = 3 Mehrotra iterations: every iterate within 1e-10 of the JAX one
  (relative to its largest entry), the host scalars within 1e-10
  relative; ``ruiz_equil_stacked``'s scaled matrices and scale vectors
  within 1e-14;
* run to convergence: the JAX tests' own KKT / oracle checks, and the
  objective within 1e-6 relative of the JAX one (both stop at tol 1e-8;
  the optimal face need not be a point).

The port runs on 1x1 and 2x2 grids; each JAX reference once, on a 1x1
JAX grid.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.optimization import soc as jsoc
from elemental_tpu_torch.optimization import soc as tsoc
from .torch_shared_ref import shared_cache

GRIDS = [(1, 1), (2, 2)]
IDS = ["1x1", "2x2"]
K_ITERS = 3


def _jd(F):
    F = np.asarray(F)
    F = F.reshape(-1, 1) if F.ndim == 1 else F
    return el.from_global(F, el.MC, el.MR,
                          grid=el.Grid(jax.devices()[:1], height=1))


def _td(F, rc=(1, 1)):
    F = np.asarray(F)
    F = F.reshape(-1, 1) if F.ndim == 1 else F
    return et.from_global(F, et.MC, et.MR, grid=et.Grid(*rc, device="cpu"))


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def _soc_interior(fi, n, seed):
    v = np.zeros(n)
    r2 = np.random.default_rng(seed)
    for h in np.unique(fi):
        sel = fi == h
        k = sel.sum()
        t = r2.normal(size=k - 1) * 0.3
        v[np.where(sel)[0][1:]] = t
        v[h] = np.linalg.norm(t) + 1.0
    return v


def _cone_interior(rng, orders):
    parts = []
    for k in orders:
        v = rng.normal(size=k)
        v[0] = np.linalg.norm(v[1:]) + rng.uniform(0.5, 2.0)
        parts.append(v)
    return np.concatenate(parts)


def _case(name):
    """(args, orders) of each problem, the JAX tests' construction."""
    if name == "socp":                      # test_solvers.py::test_socp
        rng = np.random.default_rng(20)
        sizes = [3, 4, 3]
        n, m = 10, 4
        _, fi = jsoc.make_cone_layout(sizes)
        x0 = _soc_interior(fi, n, 4)
        z0 = _soc_interior(fi, n, 5)
        A = rng.normal(size=(m, n))
        b = (A @ x0).reshape(-1, 1)
        c = (A.T @ rng.normal(size=m) + z0).reshape(-1, 1)
        return (A, b, c), sizes
    if name == "lp_affine":                 # test_affine.py::_box_lp
        rng = np.random.default_rng(3)
        m, n = 6, 14
        A = rng.normal(size=(m, n))
        b = A @ rng.uniform(0.2, 0.8, n)
        c = rng.normal(size=n)
        G = np.vstack([-np.eye(n), np.eye(n)])
        h = np.concatenate([np.zeros(n), np.ones(n)])
        return (A, G, b, c, h), None
    if name == "qp_affine":                 # test_qp_affine_matches_kkt
        rng = np.random.default_rng(6)
        n = 10
        Q0 = rng.normal(size=(n, n))
        Q = Q0 @ Q0.T + n * np.eye(n)
        c = rng.normal(size=n)
        A = np.ones((1, n))
        b = np.array([n / 2.0])
        G = np.vstack([-np.eye(n), np.eye(n)])
        h = np.concatenate([np.zeros(n), np.ones(n)])
        return (Q, A, G, b, c, h), None
    rng = np.random.default_rng(7)          # test_socp_affine
    orders = [3, 4, 2]
    k = sum(orders)
    n, m = 6, 2
    A = rng.normal(size=(m, n))
    G = rng.normal(size=(k, n))
    x0 = rng.normal(size=n)
    y0 = rng.normal(size=m)
    s0 = _cone_interior(rng, orders)
    z0 = _cone_interior(rng, orders)
    return (A, G, A @ x0, -A.T @ y0 - G.T @ z0, G @ x0 + s0), orders


def _solve(pkg, name, k, rc=(1, 1)):
    mk = _jd if pkg is el else functools.partial(_td, rc=rc)
    ctrl = pkg.MehrotraCtrl()
    if k is not None:
        ctrl = dataclasses.replace(ctrl, max_iters=k)
    args, orders = _case(name)
    dm = [mk(F) for F in args]
    if name == "socp":
        out = pkg.socp(*dm, orders, ctrl=ctrl)
        conv = (lambda A: np.asarray(el.to_global(A))) if pkg is el \
            else (lambda A: et.to_global(A).numpy())
        return [conv(v).ravel() for v in out[:3]], out[3]
    if name == "socp_affine":
        out = pkg.socp_affine(*dm, orders, ctrl=ctrl)
    else:
        out = getattr(pkg, name)(*dm, ctrl=ctrl)
    return list(out[:4]), out[4]


@shared_cache
def _jax(name, k):
    return _solve(el, name, k)


NAMES = ["socp", "lp_affine", "qp_affine", "socp_affine"]


def test_cone_algebra_matches_jax():
    sizes = [3, 5, 2, 1]
    orders, fi = tsoc.make_cone_layout(sizes)
    jo, jfi = jsoc.make_cone_layout(sizes)
    assert np.array_equal(orders, jo) and np.array_equal(fi, jfi)
    n = 11
    x = _soc_interior(fi, n, 1)
    z = _soc_interior(fi, n, 2)
    d = _soc_interior(fi, n, 3) - 2 * x
    for fn, args in (("soc_dets", (x, fi)), ("soc_apply", (x, z, fi)),
                     ("soc_inverse", (x, fi)), ("soc_sqrt", (x, fi)),
                     ("soc_identity", (fi, n)),
                     ("soc_nesterov_todd", (x, z, fi))):
        assert np.array_equal(getattr(tsoc, fn)(*args),
                              getattr(jsoc, fn)(*args)), fn
    assert tsoc.soc_max_step(x, d, fi, cap=5.0) \
        == jsoc.soc_max_step(x, d, fi, cap=5.0)
    w = tsoc.soc_nesterov_todd(x, z, fi)
    Qw = tsoc._arrow_matrix(w, orders, fi)
    assert np.linalg.norm(Qw @ z - x) < 1e-12       # NT defining identity
    e = tsoc.soc_identity(fi, n)
    assert np.allclose(tsoc.soc_apply(x, tsoc.soc_inverse(x, fi), fi), e,
                       atol=1e-12)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_ruiz_equil_stacked_matches_jax(rc):
    (A, G, b, c, h), orders = _case("socp_affine")
    rs = np.exp(np.random.default_rng(8).uniform(-5, 5, A.shape[0]))
    _, fi = tsoc.make_cone_layout(orders)
    got = et.optimization.ruiz_equil_stacked(_td(rs[:, None] * A, rc),
                                             _td(G, rc), first_inds=fi)
    want = el.optimization.ruiz_equil_stacked(_jd(rs[:, None] * A), _jd(G),
                                              first_inds=fi)
    for g, w in zip(got[:2], want[:2]):
        _close(et.to_global(g).numpy(), np.asarray(el.to_global(w)), 1e-14)
    for g, w in zip(got[2:], want[2:]):
        _close(g, w, 1e-14)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("name", NAMES)
def test_first_iterates_match_jax(name, rc):
    vecs, info = _solve(et, name, K_ITERS, rc)
    jvecs, jinfo = _jax(name, K_ITERS)
    for got, want in zip(vecs, jvecs):
        _close(got, want, 1e-10)
    assert info["iters"] == jinfo["iters"]
    for key in ("mu", "pobj"):
        assert abs(info[key] - jinfo[key]) <= 1e-10 * max(abs(jinfo[key]),
                                                          1.0)


@pytest.mark.parametrize("name", NAMES)
def test_converged_solutions(name):
    vecs, info = _solve(et, name, None)
    jvecs, jinfo = _jax(name, None)
    assert info["converged"] and jinfo["converged"]
    x = vecs[0]
    # the optimal face need not be a point: the objective is what agrees
    assert abs(info["pobj"] - jinfo["pobj"]) <= 1e-6 * (1 + abs(jinfo["pobj"]))
    args, orders = _case(name)
    if name == "socp":
        A, b, c = args
        y, z = vecs[1], vecs[2]
        assert np.linalg.norm(A @ x - b.ravel()) < 1e-5
        assert np.linalg.norm(A.T @ y + z - c.ravel()) < 1e-5
        assert abs(x @ z) < 1e-5
        _, fi = tsoc.make_cone_layout(orders)
        assert np.all(tsoc.soc_dets(x, fi) > -1e-9)
    elif name == "lp_affine":
        A, G, b, c, h = args
        from scipy.optimize import linprog
        res = linprog(c, A_ub=G, b_ub=h, A_eq=A, b_eq=b,
                      bounds=[(None, None)] * A.shape[1], method="highs")
        assert abs(c @ x - res.fun) / (1 + abs(res.fun)) < 1e-6
        assert np.linalg.norm(A @ x - b) < 1e-6
        assert np.all(G @ x - h < 1e-6)
    elif name == "qp_affine":
        Q, A, G, b, c, h = args
        y, z = vecs[1], vecs[2]
        assert np.linalg.norm(Q @ x + c + A.T @ y + G.T @ z) < 1e-5
        assert np.all(z > -1e-8) and abs(z @ (h - G @ x)) < 1e-5
    else:
        A, G, b, c, h = args
        y, z, s = vecs[1], vecs[2], vecs[3]
        assert np.linalg.norm(A @ x - b) < 1e-6
        assert np.linalg.norm(G @ x + s - h) < 1e-6
        assert np.linalg.norm(c + A.T @ y + G.T @ z) < 1e-5
        at = 0
        for kk in orders:
            assert s[at] >= np.linalg.norm(s[at + 1:at + kk]) - 1e-7
            assert z[at] >= np.linalg.norm(z[at + 1:at + kk]) - 1e-7
            at += kk
        assert abs(s @ z) < 1e-5
