"""The port's optimization models (``optimization/models.py``) against
``elemental_tpu`` and against the JAX tests' own oracles
(``tests/optimization/test_solvers.py``, ``test_models_breadth.py``), on
the same seeded inputs.

* ``bp`` (an LP) and ``nnls`` (a QP without constraints, the Cholesky
  path) stopped after k = 3 Mehrotra iterations: the returned iterate
  within 1e-10 of the JAX one (relative to its largest entry), the host
  scalars within 1e-10 relative (``tests/test_torch_lp_qp.py`` holds the
  constrained QP, ``svm``'s path, iterate by iterate);
* ``nmf`` after 5 multiplicative updates within 1e-12 of the JAX factors
  (both start from ``numpy.random.default_rng(seed)``);
* every model run to convergence passes its JAX test's check: the
  recovered signal (``bp``, ``lav``), scipy's NNLS, the Lasso KKT bound,
  separation (``svm``), the low-rank recovery (``rpca``, 1e-5), HiGHS'
  Chebyshev objective (``cp``), Dantzig feasibility (``ds``), elastic-net
  optimality against perturbations (``en``), the reconstruction
  (``nmf``), the graphical-lasso KKT conditions (``sparse_inv_cov``), the
  portfolio's budget and corners, the TV denoising.

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
from .torch_shared_ref import shared_cache

K_ITERS = 3


def _jd(F):
    return el.from_global(np.atleast_2d(np.asarray(F, np.float64)),
                          el.MC, el.MR,
                          grid=el.Grid(jax.devices()[:1], height=1))


def _td(F, rc=(1, 1)):
    return et.from_global(np.atleast_2d(np.asarray(F, np.float64)),
                          et.MC, et.MR, grid=et.Grid(*rc, device="cpu"))


def _tn(A):
    return et.to_global(A).numpy()


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def _data(name):
    if name == "bp":
        rng = np.random.default_rng(4)
        A = rng.normal(size=(10, 24))
        x_true = np.zeros((24, 1))
        x_true[[2, 9, 17], 0] = [1.5, -2.0, 0.7]
        return (A, A @ x_true), x_true
    if name == "lav":
        rng = np.random.default_rng(5)
        A = rng.normal(size=(24, 6))
        x_true = rng.normal(size=(6, 1))
        b = A @ x_true
        b[3] += 10.0
        return (A, b), x_true
    if name in ("nnls", "lasso"):
        rng = np.random.default_rng(3 if name == "nnls" else 6)
        shape = (20, 10) if name == "nnls" else (16, 8)
        return (rng.normal(size=shape), rng.normal(size=(shape[0], 1))), None
    rng = np.random.default_rng(7)                 # svm
    X = np.vstack([rng.normal(size=(12, 4)) + 2,
                   rng.normal(size=(12, 4)) - 2])
    return (X,), np.concatenate([np.ones(12), -np.ones(12)])


def _model(pkg, name, k, rc=(1, 1)):
    mk = _jd if pkg is el else functools.partial(_td, rc=rc)
    ctrl = pkg.MehrotraCtrl()
    if k is not None:
        ctrl = dataclasses.replace(ctrl, max_iters=k)
    args, extra = _data(name)
    dm = [mk(F) for F in args]
    conv = (lambda A: np.asarray(el.to_global(A))) if pkg is el else _tn
    if name == "svm":
        w, bias, info = pkg.svm(dm[0], extra, C=10.0, ctrl=ctrl)
        return conv(w), bias, info
    if name == "lasso":
        x, info = pkg.lasso(*dm, lam=2.0, ctrl=ctrl)
    else:
        x, info = getattr(pkg, name)(*dm, ctrl=ctrl)
    return conv(x), None, info


@shared_cache
def _jax(name, k):
    return _model(el, name, k)


@pytest.mark.parametrize("rc", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
@pytest.mark.parametrize("name", ["bp", "nnls"])
def test_first_iterates_match_jax(name, rc):
    x, bias, info = _model(et, name, K_ITERS, rc)
    xj, biasj, ij = _jax(name, K_ITERS)
    _close(x, xj, 1e-10)
    assert info["iters"] == ij["iters"]
    for key in ("mu", "pobj"):
        assert abs(info[key] - ij[key]) <= 1e-10 * max(abs(ij[key]), 1.0)


@pytest.mark.parametrize("name", ["bp", "lav", "nnls", "lasso", "svm"])
def test_lp_qp_models_meet_the_jax_oracles(name):
    x, bias, info = _model(et, name, None, (2, 2))
    args, extra = _data(name)
    if name in ("bp", "lav"):
        assert np.linalg.norm(x - extra) < 1e-6
    elif name == "nnls":
        from scipy.optimize import nnls
        A, b = args
        assert x.min() > -1e-9
        assert np.linalg.norm(x.ravel() - nnls(A, b.ravel())[0]) < 1e-6
    elif name == "lasso":
        A, b = args
        assert np.all(np.abs(A.T @ (A @ x - b)) <= 2.0 + 1e-6)
    else:
        pred = np.sign(args[0] @ x.ravel() + bias)
        assert (pred == extra).all()


def test_rpca_recovers_the_low_rank_part():
    rng = np.random.default_rng(8)                 # test_rpca_recovery
    n = 60
    L0 = rng.normal(size=(n, 3)) @ rng.normal(size=(3, n))
    S0 = np.zeros((n, n))
    idx = rng.choice(n * n, n * n // 20, replace=False)
    S0.flat[idx] = rng.normal(size=len(idx)) * 5
    L, S, info = et.rpca(_td(L0 + S0), tol=1e-7)
    assert info["converged"]
    assert np.linalg.norm(_tn(L) - L0) / np.linalg.norm(L0) < 1e-5


def _nmf_data():
    rng = np.random.default_rng(3)                 # test_nmf
    W0 = np.abs(rng.normal(size=(30, 4)))
    H0 = np.abs(rng.normal(size=(4, 24)))
    return W0 @ H0


def test_nmf_first_updates_match_jax_and_converge():
    X = _nmf_data()
    W, H, info = et.nmf(_td(X, (2, 2)), 4, max_iters=5)
    Wj, Hj, ij = el.nmf(_jd(X), 4, max_iters=5)
    _close(_tn(W), np.asarray(el.to_global(Wj)), 1e-12)
    _close(_tn(H), np.asarray(el.to_global(Hj)), 1e-12)
    assert abs(info["rel_err"] - ij["rel_err"]) < 1e-12
    W, H, info = et.nmf(_td(X), 4, max_iters=400)
    Wg, Hg = _tn(W), _tn(H)
    assert np.all(Wg >= 0) and np.all(Hg >= 0)
    assert info["rel_err"] < 5e-2
    assert np.linalg.norm(Wg @ Hg - X) / np.linalg.norm(X) < 5e-2


def test_sparse_inv_cov_meets_the_glasso_kkt_conditions():
    rng = np.random.default_rng(4)                 # test_sparse_inv_cov
    n, N = 10, 4000
    P = np.eye(n) * 2.0
    P[np.arange(1, n), np.arange(n - 1)] = 0.6
    P[np.arange(n - 1), np.arange(1, n)] = 0.6
    Xs = rng.multivariate_normal(np.zeros(n), np.linalg.inv(P), size=N)
    S = np.cov(Xs.T)
    lam = 0.05
    X, info = et.sparse_inv_cov(_td(S), lam, max_iters=200)
    Xg = _tn(X)
    assert np.allclose(Xg, Xg.T, atol=1e-8)
    grad = S - np.linalg.inv(Xg + 1e-12 * np.eye(n))
    on = np.abs(Xg) > 1e-6
    assert np.abs(grad[on] + lam * np.sign(Xg[on])).max() < 5e-2
    assert np.abs(grad[~on]).max() <= lam + 5e-2


def test_affine_models_meet_the_jax_oracles():
    from scipy.optimize import linprog
    rng = np.random.default_rng(0)                 # test_cp_chebyshev
    m, n = 40, 8
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    x, info = et.cp(_td(A), _td(b.reshape(-1, 1)))
    assert info["converged"], info
    G = np.block([[A, -np.ones((m, 1))], [-A, -np.ones((m, 1))]])
    res = linprog(np.r_[np.zeros(n), 1.0], A_ub=G, b_ub=np.r_[b, -b],
                  bounds=[(None, None)] * (n + 1), method="highs")
    assert abs(np.abs(A @ x - b).max() - res.fun) / (1 + res.fun) < 1e-5

    rng = np.random.default_rng(1)                 # test_ds_dantzig_selector
    A = rng.normal(size=(30, 10))
    xs = np.zeros(10)
    xs[[1, 4]] = [2.0, -3.0]
    b = A @ xs
    x, info = et.ds(_td(A), _td(b.reshape(-1, 1)), 0.5)
    assert info["converged"], info
    assert np.abs(A.T @ (b - A @ x)).max() <= 0.5 + 1e-5
    assert np.abs(x).sum() <= np.abs(xs).sum() + 1e-4

    rng = np.random.default_rng(2)                 # test_en_elastic_net
    A = rng.normal(size=(40, 12))
    b = rng.normal(size=40)
    x, info = et.en(_td(A, (2, 2)), _td(b.reshape(-1, 1), (2, 2)), 0.7, 0.3)
    assert info["converged"], info

    def obj(v):
        return 0.5 * np.sum((A @ v - b) ** 2) + 0.7 * np.abs(v).sum() \
            + 0.15 * np.sum(v * v)
    f0 = obj(x)
    for _ in range(30):
        assert f0 <= obj(x + 1e-3 * rng.normal(size=12)) + 1e-9

    rng = np.random.default_rng(5)                 # test_long_only_portfolio
    n = 8
    G0 = rng.normal(size=(n, n))
    Sigma = G0 @ G0.T / n + 0.1 * np.eye(n)
    mu = rng.uniform(0.0, 0.2, n)
    x, info = et.long_only_portfolio(_td(Sigma), mu, gamma=0.5)
    assert info["converged"], info
    assert abs(x.sum() - 1.0) < 1e-6 and x.min() > -1e-7

    def risk(v):
        return -mu @ v + 0.5 * np.sqrt(v @ Sigma @ v)
    assert risk(x) <= risk(np.ones(n) / n) + 1e-6
    for i in range(n):
        assert risk(x) <= risk(np.eye(n)[i]) + 1e-6


def test_tv_denoises_on_the_grid_it_is_given():
    rng = np.random.default_rng(6)                 # test_tv_denoise
    n = 60
    truth = np.concatenate([np.zeros(n // 3), np.ones(n // 3) * 2,
                            np.zeros(n - 2 * (n // 3))])
    b = truth + 0.15 * rng.normal(size=n)
    x, info = et.tv(b, lam=1.0, grid=et.Grid(device="cpu"))
    assert info["converged"], info
    assert x.dtype == b.dtype
    assert np.linalg.norm(x - truth) < np.linalg.norm(b - truth)
    assert np.abs(np.diff(x)).sum() < np.abs(np.diff(b)).sum() / 3
