"""The port's sparse IPMs (``optimization/sparse_ipm.py``) against
``elemental_tpu``, on the inputs of ``tests/optimization/test_sparse_ipm.py``
(made from the same seeds with numpy).

* ``sparse_ruiz_equil`` (host numpy in both packages) gives the same bits;
* ``_pcg_device``, the masked CG chunks the card replays as a CUDA graph
  and the CPU runs eagerly: the same iteration count as the JAX
  ``lax.while_loop`` (converged, capped by ``maxiter``, stopped by a
  non-positive curvature) and w within 1e-13 of its w (relative to the
  largest entry);
* ``lp_sparse`` with both KKT engines stopped after k = 3 Mehrotra
  iterations: x, y, z within 1e-10 of the JAX iterate, the host scalars
  within 1e-10 and the total CG iteration count within 1% (the inner
  solves stop at a relative residual, and a last-bit difference can move
  one solve's last iteration);
* ``lp_sparse``, ``bp_sparse`` and ``lav_sparse`` run to convergence: the
  JAX tests' own oracles (HiGHS objectives, recovery of the planted
  signal).

The port runs on 1x1 and 2x2 grids; each JAX reference once, on a 1x1
JAX grid.
"""
import functools

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import linprog

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.core.multivec import (mv_from_global as j_mv,
                                         mv_to_global as j_mvg)
from elemental_tpu_torch.core.multivec import (mv_from_global as t_mv,
                                               mv_to_global as t_mvg)
from elemental_tpu.optimization import sparse_ipm as jsi
from elemental_tpu_torch.optimization import sparse_ipm as tsi

GRIDS = [(1, 1), (2, 2)]
IDS = ["1x1", "2x2"]
K_ITERS = 3


def _jgrid():
    return el.Grid(jax.devices()[:1], height=1)


def _tgrid(rc=(1, 1)):
    return et.Grid(*rc, device="cpu")


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def _rand_sparse(rng, m, n, nnz):
    return rng.integers(0, m, nnz), rng.integers(0, n, nnz), \
        rng.normal(size=nnz)


def _lp_case(name):
    """test_sparse_ipm.py's LPs: 'oracle' (seed 0) and 'scaled' (seed 1,
    rows scaled by e^U(-5, 5))."""
    rng = np.random.default_rng(0 if name == "oracle" else 1)
    m, n, nnz = (40, 100, 400) if name == "oracle" else (30, 80, 320)
    rows, cols, vals = _rand_sparse(rng, m, n, nnz)
    if name == "scaled":
        vals = vals * np.exp(rng.uniform(-5, 5, m))[rows]
    As = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    b = As @ rng.uniform(0.5, 1.5, n)
    c = As.T @ rng.normal(size=m) + rng.uniform(0.1, 2.0, n)
    return rows, cols, vals, m, n, b, c, As


def _lp(pkg, name, kkt, k, rc=(1, 1)):
    rows, cols, vals, m, n, b, c, _ = _lp_case(name)
    grid = _jgrid() if pkg is el else _tgrid(rc)
    mv, mvg = (j_mv, j_mvg) if pkg is el else (t_mv, t_mvg)
    A = pkg.dist_sparse_from_coo(rows, cols, vals, m, n, grid=grid,
                                 dtype=np.float64)
    x, y, z, info = pkg.lp_sparse(
        A, mv(b.reshape(-1, 1), grid=grid), mv(c.reshape(-1, 1), grid=grid),
        pkg.MehrotraCtrl(tol=1e-6, max_iters=k), kkt=kkt)
    conv = (lambda v: np.asarray(mvg(v))) if pkg is el \
        else (lambda v: mvg(v).numpy())
    return conv(x), conv(y), conv(z), info


@functools.cache
def _jax_lp(name, kkt, k):
    return _lp(el, name, kkt, k)


def test_sparse_ruiz_equil_matches_jax():
    rows, cols, vals, m, n, *_ = _lp_case("scaled")
    for got, want in zip(tsi.sparse_ruiz_equil(rows, cols, vals, m, n),
                         jsi.sparse_ruiz_equil(rows, cols, vals, m, n)):
        assert np.array_equal(got, want)


def _pcg_inputs(case):
    rng = np.random.default_rng(11)
    m, n = 30, 70
    rows, cols, vals = _rand_sparse(rng, m, n, 280)
    d2 = rng.uniform(0.1, 3.0, n)
    b = rng.normal(size=m)
    As = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    diag = (As.multiply(As) @ d2) + 1e-3
    dinv = 1.0 / diag
    if case == "indefinite":          # reg < 0: p' M p <= 0 stops the loop
        reg = -1e3
    else:
        reg = 1e-3
    maxiter = 7 if case == "capped" else 200
    return rows, cols, vals, m, n, d2, b, dinv, reg, maxiter


@functools.cache
def _jax_pcg(case):
    rows, cols, vals, m, n, d2, b, dinv, reg, maxiter = _pcg_inputs(case)
    g = _jgrid()
    A = el.dist_sparse_from_coo(rows, cols, vals, m, n, grid=g)
    w, it = jsi._pcg_device(A, j_mv(d2.reshape(-1, 1), grid=g), reg,
                            j_mv(b.reshape(-1, 1), grid=g),
                            j_mv(dinv.reshape(-1, 1), grid=g), 1e-12,
                            maxiter)
    return np.asarray(j_mvg(w)), int(it)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("case", ["converged", "capped", "indefinite"])
def test_pcg_device_matches_the_jax_while_loop(case, rc):
    rows, cols, vals, m, n, d2, b, dinv, reg, maxiter = _pcg_inputs(case)
    g = _tgrid(rc)
    A = et.dist_sparse_from_coo(rows, cols, vals, m, n, grid=g)
    before = dict(tsi.PCG_COUNTS)
    w, it = tsi._pcg_device(A, t_mv(d2.reshape(-1, 1), grid=g), reg,
                            t_mv(b.reshape(-1, 1), grid=g),
                            t_mv(dinv.reshape(-1, 1), grid=g), 1e-12,
                            maxiter)
    wj, itj = _jax_pcg(case)
    assert int(it) == itj
    _close(t_mvg(w).numpy(), wj, 1e-13)
    chunks = tsi.PCG_COUNTS["chunks"] - before["chunks"]
    assert chunks == tsi.PCG_COUNTS["reads"] - before["reads"]
    assert chunks == max(-(-itj // tsi.PCG_CHUNK), 1)
    if case == "converged":
        assert itj < maxiter
    elif case == "capped":
        assert itj == maxiter


def test_masked_chunk_iterations_after_the_end_change_nothing():
    """Chunks of 1 and of 64 iterations give the same bits."""
    rows, cols, vals, m, n, d2, b, dinv, reg, maxiter = \
        _pcg_inputs("converged")
    g = _tgrid()
    A = et.dist_sparse_from_coo(rows, cols, vals, m, n, grid=g)
    args = (t_mv(d2.reshape(-1, 1), grid=g), reg,
            t_mv(b.reshape(-1, 1), grid=g),
            t_mv(dinv.reshape(-1, 1), grid=g), 1e-12, maxiter)
    w1, it1 = tsi._pcg_eager(A, *args, chunk=1)
    w64, it64 = tsi._pcg_eager(A, *args, chunk=64)
    assert int(it1) == int(it64)
    assert torch.equal(w1.local, w64.local)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("kkt", ["direct", "cg"])
def test_first_iterates_match_jax(kkt, rc):
    x, y, z, info = _lp(et, "oracle", kkt, K_ITERS, rc)
    xj, yj, zj, ij = _jax_lp("oracle", kkt, K_ITERS)
    for got, want in ((x, xj), (y, yj), (z, zj)):
        _close(got, want, 1e-10)
    assert info["iters"] == ij["iters"]
    for key in ("mu", "pobj", "dobj"):
        assert abs(info[key] - ij[key]) <= 1e-10 * max(abs(ij[key]), 1.0)
    # a last-bit difference may move a solve's stopping iteration by one
    assert abs(info["cg_iters"] - ij["cg_iters"]) <= 0.01 * ij["cg_iters"], \
        (info["cg_iters"], ij["cg_iters"])


@pytest.mark.parametrize("name,kkt", [("oracle", "direct"), ("oracle", "cg"),
                                      ("scaled", "auto")])
def test_lp_sparse_converges_to_highs(name, kkt):
    x, y, z, info = _lp(et, name, kkt, 60)
    assert info["converged"], info
    if kkt == "cg":
        assert info["cg_iters"] > 0
    *_, b, c, As = _lp_case(name)
    res = linprog(c, A_eq=As.toarray(), b_eq=b, bounds=[(0, None)] * c.size,
                  method="highs")
    assert res.status == 0
    tol = 1e-5 if name == "oracle" else 1e-4
    assert abs(c @ x.ravel() - res.fun) / (1 + abs(res.fun)) < tol


def test_bp_and_lav_sparse_models():
    rng = np.random.default_rng(2)                 # test_bp_sparse_recovery
    m, n = 60, 160
    rows, cols, vals = _rand_sparse(rng, m, n, 900)
    As = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    xs = np.zeros(n)
    sup = rng.choice(n, 6, replace=False)
    xs[sup] = rng.normal(size=6) * 3
    b = As @ xs
    g = _tgrid((2, 2))
    A = et.dist_sparse_from_coo(rows, cols, vals, m, n, grid=g,
                                dtype=np.float64)
    x, info = et.bp_sparse(A, t_mv(b.reshape(-1, 1), grid=g),
                           et.MehrotraCtrl(tol=1e-6, max_iters=80))
    assert info["converged"], info
    xg = t_mvg(x).numpy().ravel()
    assert np.linalg.norm(As @ xg - b) / np.linalg.norm(b) < 1e-5
    res = linprog(np.ones(2 * n), A_eq=sp.hstack([As, -As]).toarray(),
                  b_eq=b, bounds=[(0, None)] * (2 * n), method="highs")
    assert abs(np.abs(xg).sum() - res.fun) / (1 + abs(res.fun)) < 1e-4

    rng = np.random.default_rng(3)                 # test_lav_sparse_small
    m, n = 80, 30
    rows, cols, vals = _rand_sparse(rng, m, n, 600)
    As = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    xt = rng.normal(size=n)
    b = As @ xt
    out = rng.choice(m, 8, replace=False)
    b[out] += rng.normal(size=8) * 20
    A = et.dist_sparse_from_coo(rows, cols, vals, m, n, grid=g,
                                dtype=np.float64)
    x, info = et.lav_sparse(A, t_mv(b.reshape(-1, 1), grid=g),
                            et.MehrotraCtrl(tol=1e-6, max_iters=80))
    assert info["converged"], info
    xg = t_mvg(x).numpy().ravel()
    assert np.linalg.norm(xg - xt) / np.linalg.norm(xt) < 1e-5
    assert np.array_equal(et.optimization.sparse_to_coo(A)[1],
                          et.sparse.sparse_to_coo(A)[1])


def test_kkt_engine_choice():
    rows, cols, vals, m, n, b, c, _ = _lp_case("oracle")
    g = _tgrid()
    A = et.dist_sparse_from_coo(rows, cols, vals, m, n, grid=g)
    with pytest.raises(ValueError):
        et.lp_sparse(A, t_mv(b.reshape(-1, 1), grid=g),
                     t_mv(c.reshape(-1, 1), grid=g), kkt="lu")
    with pytest.raises(ValueError):
        et.lp_sparse(A, t_mv(b[:-1].reshape(-1, 1), grid=g),
                     t_mv(c.reshape(-1, 1), grid=g))
