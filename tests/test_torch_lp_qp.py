"""The port's dense IPMs and their helpers (``optimization/lp.py``,
``qp.py``, ``util.py``, ``prox.py``, ``equilibrate.py``) against
``elemental_tpu``, on the inputs of ``tests/optimization/test_solvers.py``
and ``test_affine.py`` (made from the same seeds with numpy).

* ``lp`` and ``qp`` (with and without equality constraints) stopped after
  k = 3 Mehrotra iterations: x, y, z within 1e-10 of the JAX iterate
  (relative to its largest entry), the host scalars (``mu``, ``pobj``,
  ``dobj``) within 1e-10 relative, the same iteration count;
* run to convergence: the JAX tests' own checks (feasibility, the
  duality gap, scipy's optimum) and agreement with the JAX solution to
  1e-7 relative (both stop at tol 1e-8);
* the equilibration scale vectors and scaled matrices within 1e-14,
  ``max_step`` / ``num_outside`` equal and the elementwise proximal
  operators within 1e-13 of the JAX package's; ``svt`` (through the
  port's SVD) within 1e-9 of numpy's thresholded SVD, the JAX test's
  check.

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
from elemental_tpu.optimization import prox as jprox
from elemental_tpu_torch.optimization import prox as tprox
from elemental_tpu.optimization import equilibrate as jeq
from elemental_tpu_torch.optimization import equilibrate as teq

GRIDS = [(1, 1), (2, 2)]
IDS = ["1x1", "2x2"]
K_ITERS = 3


def _jd(F):
    return el.from_global(np.asarray(F), el.MC, el.MR,
                          grid=el.Grid(jax.devices()[:1], height=1))


def _td(F, rc=(1, 1)):
    return et.from_global(np.asarray(F), et.MC, et.MR,
                          grid=et.Grid(*rc, device="cpu"))


def _jn(A):
    return np.asarray(el.to_global(A))


def _tn(A):
    return et.to_global(A).numpy()


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def _feasible_lp(rng, m, n):
    A = rng.normal(size=(m, n))
    x0 = rng.uniform(0.5, 2.0, size=(n, 1))
    b = A @ x0
    y0 = rng.normal(size=(m, 1))
    z0 = rng.uniform(0.5, 2.0, size=(n, 1))
    c = A.T @ y0 + z0
    return A, b, c


def _qp_data(constrained: bool):
    rng = np.random.default_rng(2)
    n, m = 12, 4
    G0 = rng.normal(size=(n, n))
    Q = G0 @ G0.T / n + np.eye(n)
    A = rng.normal(size=(m, n))
    b = A @ rng.uniform(0.5, 1.5, size=(n, 1))
    c = rng.normal(size=(n, 1))
    return (Q, c, A, b) if constrained else (Q, c)


def _lp_data(name):
    if name == "lp":
        return _feasible_lp(np.random.default_rng(0), 10, 24)
    if name == "lp_scipy":
        return _feasible_lp(np.random.default_rng(1), 8, 20)
    # test_affine.py::test_direct_lp_badly_scaled_with_ruiz's scaling
    A, b, c = _feasible_lp(np.random.default_rng(23), 8, 20)
    r = 10.0 ** np.random.default_rng(24).uniform(-3, 3, 8)
    return A * r[:, None], b * r[:, None], c


def _solve(pkg, name, k, rc=(1, 1)):
    mk = _jd if pkg is el else functools.partial(_td, rc=rc)
    ctrl = (el if pkg is el else et).MehrotraCtrl()
    if k is not None:
        ctrl = dataclasses.replace(ctrl, max_iters=k)
    if name.startswith("lp"):
        x, y, z, info = pkg.lp(*[mk(F) for F in _lp_data(name)], ctrl)
    else:
        data = _qp_data(name == "qp_eq")
        args = [mk(F) for F in data]
        x, y, z, info = pkg.qp(*args, ctrl=ctrl)
    conv = _jn if pkg is el else _tn
    return conv(x), (None if y is None else conv(y)), conv(z), info


@functools.cache
def _jax(name, k):
    return _solve(el, name, k)


NAMES = ["lp", "lp_scaled", "qp_eq", "qp_free"]


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("name", NAMES)
def test_first_iterates_match_jax(name, rc):
    x, y, z, info = _solve(et, name, K_ITERS, rc)
    xj, yj, zj, ij = _jax(name, K_ITERS)
    for got, want in ((x, xj), (y, yj), (z, zj)):
        if want is not None:
            _close(got, want, 1e-10)
    assert info["iters"] == ij["iters"] == K_ITERS - 1
    for key in ("mu", "pobj") + (("dobj",) if name.startswith("lp") else ()):
        assert abs(info[key] - ij[key]) <= 1e-10 * max(abs(ij[key]), 1.0)


@pytest.mark.parametrize("name", NAMES + ["lp_scipy"])
def test_converged_solutions(name):
    x, y, z, info = _solve(et, name, None)
    xj, _, _, ij = _jax(name, None)
    assert info["converged"] and ij["converged"]
    assert abs(info["iters"] - ij["iters"]) <= 1
    _close(x, xj, 1e-7)
    if name.startswith("lp"):
        A, b, c = _lp_data(name)
        assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-7
        assert np.linalg.norm(A.T @ y + z - c) / np.linalg.norm(c) < 1e-7
        assert x.min() > -1e-10 and z.min() > -1e-10
        gap = abs((c.T @ x).item() - (b.T @ y).item())
        assert gap < 1e-6 * (1 + abs((c.T @ x).item()))
        if name == "lp_scipy":
            from scipy.optimize import linprog
            res = linprog(c.ravel(), A_eq=A, b_eq=b.ravel(),
                          bounds=(0, None), method="highs")
            assert abs((c.T @ x).item() - res.fun) < 1e-6 * (1 + abs(res.fun))
    elif name == "qp_eq":
        Q, c, A, b = _qp_data(True)
        assert np.linalg.norm(A @ x - b) < 1e-7 * (1 + np.linalg.norm(b))
        r = Q @ x + c - A.T @ y - z
        assert np.linalg.norm(r) < 1e-6 * (1 + np.linalg.norm(c))
        assert (x.T @ z).item() < 1e-6
    else:
        Q, c = _qp_data(False)
        g = Q @ x + c
        assert x.min() > -1e-9 and g.min() > -1e-6
        assert np.abs(x * g).max() < 1e-6


def _badly_scaled(seed=30):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(9, 7)) * 10.0 ** rng.uniform(-4, 4, (9, 1)) \
        * 10.0 ** rng.uniform(-3, 3, (1, 7))
    A[2, 3] = 0.0
    A[:, 5] = 0.0
    return A


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_equilibration_matches_jax(rc):
    A = _badly_scaled()
    S = A @ A.T
    for fn in ("ruiz_equil", "geom_equil"):
        As, dr, dc = getattr(teq, fn)(_td(A, rc))
        Js, jr, jc = getattr(jeq, fn)(_jd(A))
        _close(_tn(As), _jn(Js), 1e-14)
        _close(dr.numpy(), np.asarray(jr), 1e-14)
        _close(dc.numpy(), np.asarray(jc), 1e-14)
    Qs, d = teq.symmetric_ruiz_equil(_td(S, rc))
    Js, jd = jeq.symmetric_ruiz_equil(_jd(S))
    _close(_tn(Qs), _jn(Js), 1e-14)
    _close(d.numpy(), np.asarray(jd), 1e-14)
    for got, want in zip(teq.row_col_minabs(_td(A, rc)),
                         jeq.row_col_minabs(_jd(A))):
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_cone_utilities_and_prox_match_jax(rc):
    rng = np.random.default_rng(9)
    F = rng.normal(size=(9, 7))
    D = rng.normal(size=(9, 7))
    X = np.abs(rng.normal(size=(9, 7)))
    assert float(et.optimization.max_step(_td(X, rc), _td(D, rc), cap=3.0)) \
        == float(el.optimization.max_step(_jd(X), _jd(D), cap=3.0))
    assert int(et.optimization.num_outside(_td(F, rc))) \
        == int(el.optimization.num_outside(_jd(F)))
    A = _td(F, rc)
    cases = [("soft_threshold", (0.5,)), ("clip", (-0.3, 0.3)),
             ("frobenius_prox", (2.0,)), ("hinge_loss_prox", (0.7,)),
             ("logistic_prox", (0.5, 12))]
    for name, args in cases:
        got = _tn(getattr(tprox, name)(A, *args))
        want = _jn(getattr(jprox, name)(_jd(F), *args))
        _close(got, want, 1e-13)
    np.testing.assert_allclose(_tn(tprox.soft_threshold(A, 0.5)),
                               np.sign(F) * np.maximum(np.abs(F) - 0.5, 0))
    sv = _tn(tprox.svt(A, 0.8))
    U, s, Vh = np.linalg.svd(F, full_matrices=False)
    assert np.linalg.norm(sv - (U * np.maximum(s - 0.8, 0)) @ Vh) < 1e-9
