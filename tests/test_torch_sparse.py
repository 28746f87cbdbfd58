"""The port's sparse layer (``sparse/core.py``, ``sparse/solvers.py``)
against ``elemental_tpu``: the same seeded COO triplets go through both
packages.

* ``DistSparseMatrix`` storage (``vals``, ``rows_loc``, ``cols``, ``nnz``)
  is bit-equal on 1x1, 2x2 and 2x4 grids, so are ``to_dense``,
  ``sparse_to_coo``, ``DistMap.translate`` and ``Graph.process_queues``;
* ``spmv`` / ``spmv_adjoint`` agree to 1e-13 relative in float64 and
  complex128 (the port sums by fixed segment trees, XLA in its scatter
  order: the last bits differ);
* ``cg``, ``cgls``, ``gmres`` and ``sparse_direct_solve`` agree to 1e-13
  relative with the same iteration counts.

One test holds the signature of every name the JAX ``sparse``,
``optimization``, ``lattice`` and ``io`` packages export, and of their
package-level twins, equal to the JAX one.  JAX references run on a 1x1
JAX grid (one device: no XLA rendezvous), once per input.
"""
import functools
import inspect

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.core.multivec import (mv_from_global as j_mv,
                                         mv_to_global as j_mvg)
from elemental_tpu_torch.core.multivec import (mv_from_global as t_mv,
                                               mv_to_global as t_mvg)

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]
REL = 1e-13


def _jgrid(r=1, c=1):
    return el.Grid(jax.devices()[:r * c], height=r)


def _tgrid(r=1, c=1):
    return et.Grid(r, c, device="cpu")


def _coo(seed, m, n, density=0.3, dtype=np.float64):
    """Random triplets with duplicates (they must sum) and a dense row."""
    rng = np.random.default_rng(seed)
    k = int(density * m * n)
    rows = np.concatenate([rng.integers(0, m, k), np.full(n, m // 3)])
    cols = np.concatenate([rng.integers(0, n, k), np.arange(n)])
    vals = rng.normal(size=rows.size)
    if np.issubdtype(dtype, np.complexfloating):
        vals = vals + 1j * rng.normal(size=rows.size)
    return rows, cols, vals.astype(dtype)


def _laplacian_2d(k):
    """The 5-point Laplacian on a k x k grid (SPD)."""
    n = k * k
    i = np.arange(n)
    r, c = i // k, i % k
    rows, cols, vals = [i], [i], [np.full(n, 4.0)]
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ok = (r + dr >= 0) & (r + dr < k) & (c + dc >= 0) & (c + dc < k)
        rows.append(i[ok])
        cols.append(((r + dr) * k + c + dc)[ok])
        vals.append(np.full(int(ok.sum()), -1.0))
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), n)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("pad_to", [None, 200])
@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_storage_bit_equal(rc, pad_to):
    rows, cols, vals = _coo(0, 29, 17)
    J = el.dist_sparse_from_coo(rows, cols, vals, 29, 17, grid=_jgrid(*rc),
                                pad_to=pad_to)
    T = et.dist_sparse_from_coo(rows, cols, vals, 29, 17, grid=_tgrid(*rc),
                                pad_to=pad_to)
    for f in ("vals", "rows_loc", "cols"):
        a, b = np.asarray(getattr(J, f)), getattr(T, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b), f
    assert (T.nnz, T.gshape) == (J.nnz, J.gshape)
    # the queue-building front end and the host bridges
    Sj, St = el.SparseMatrix(29, 17), et.SparseMatrix(29, 17)
    for i, j, v in zip(rows[:40], cols[:40], vals[:40]):
        Sj.queue_update(int(i), int(j), float(v))
        St.queue_update(int(i), int(j), float(v))
    Fj, Ft = Sj.freeze(grid=_jgrid(*rc)), St.freeze(grid=_tgrid(*rc))
    assert np.array_equal(np.asarray(Fj.vals), Ft.vals.numpy())
    for a, b in zip(el.sparse.sparse_to_coo(J), et.sparse.sparse_to_coo(T)):
        assert np.array_equal(np.asarray(a), b)
    assert np.array_equal(np.asarray(el.to_global(J.to_dense())),
                          et.to_global(T.to_dense()).numpy())


def test_graph_and_distmap_match_jax():
    gj, gt = el.Graph(6, 5), et.Graph(6, 5)
    for s, t in ((3, 1), (0, 4), (3, 1), (5, 0), (0, 2)):
        gj.queue_connection(s, t)
        gt.queue_connection(s, t)
    for a, b in zip(gj.process_queues(), gt.process_queues()):
        assert np.array_equal(a, b)
    assert gt.num_edges == gj.num_edges == 4
    with pytest.raises(ValueError):
        gt.queue_connection(6, 0)
    with pytest.raises(ValueError):
        et.DistMap([0, 0, 1])
    image = np.random.default_rng(1).permutation(13)
    X = np.random.default_rng(2).normal(size=(13, 2))
    for rc in GRIDS:
        wj = el.DistMap(image, _jgrid(*rc)).translate(j_mv(X, grid=_jgrid(*rc)))
        wt = et.DistMap(image, _tgrid(*rc)).translate(t_mv(X, grid=_tgrid(*rc)))
        assert np.array_equal(np.asarray(wj.local), wt.local.numpy())


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_spmv_matches_jax(rc, dtype):
    m, n = 37, 23
    rows, cols, vals = _coo(3, m, n, dtype=dtype)
    rng = np.random.default_rng(4)
    X = rng.normal(size=(n, 3)).astype(dtype)
    Y = rng.normal(size=(m, 3)).astype(dtype)
    jg, tg = _jgrid(*rc), _tgrid(*rc)
    J = el.dist_sparse_from_coo(rows, cols, vals, m, n, grid=jg)
    T = et.dist_sparse_from_coo(rows, cols, vals, m, n, grid=tg)
    y_j = j_mvg(J.spmv(j_mv(X, grid=jg), alpha=0.5))
    y_t = t_mvg(T.spmv(t_mv(X, grid=tg), alpha=0.5)).numpy()
    _close(y_t, y_j)
    a_j = j_mvg(J.spmv_adjoint(j_mv(Y, grid=jg)))
    a_t = t_mvg(T.spmv_adjoint(t_mv(Y, grid=tg))).numpy()
    _close(a_t, a_j)
    dense = np.zeros((m, n), dtype)
    np.add.at(dense, (rows, cols), vals)
    _close(y_t, 0.5 * dense @ X, 1e-12)
    _close(a_t, dense.conj().T @ Y, 1e-12)


def test_spmv_is_deterministic_and_with_values_keeps_the_plan():
    rows, cols, vals, n = _laplacian_2d(9)
    T = et.dist_sparse_from_coo(rows, cols, vals, n, n, grid=_tgrid(2, 2))
    x = t_mv(np.random.default_rng(5).normal(size=(n, 1)), grid=_tgrid(2, 2))
    assert torch.equal(T.spmv(x).local, T.spmv(x).local)
    assert torch.equal(T.spmv_adjoint(x).local, T.spmv_adjoint(x).local)
    T2 = T.with_values(T.vals * T.vals)
    assert T2._plans is T._plans
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals * vals)
    _close(t_mvg(T2.spmv(x)).numpy(), dense @ t_mvg(x).numpy(), 1e-14)
    with pytest.raises(ValueError):
        T.spmv(t_mv(np.ones((n + 1, 1)), grid=_tgrid(2, 2)))


def _system(name):
    if name in ("cg", "sparse_direct_solve"):
        rows, cols, vals, n = _laplacian_2d(12)
        m = n
    elif name == "cgls":
        rows, cols, vals = _coo(6, 40, 15, density=0.25)
        m, n = 40, 15
    else:                                  # gmres: nonsymmetric
        rows, cols, vals, n = _laplacian_2d(10)
        vals = vals + 0.3 * (cols > rows)
        m = n
    b = np.random.default_rng(7).normal(size=(m, 1))
    return rows, cols, vals, m, n, b


def _run(pkg, name, rc):
    rows, cols, vals, m, n, b = _system(name)
    if pkg is el:
        grid, mv, mvg = _jgrid(*rc), j_mv, j_mvg
    else:
        grid, mv, mvg = _tgrid(*rc), t_mv, t_mvg
    A = pkg.dist_sparse_from_coo(rows, cols, vals, m, n, grid=grid)
    kw = {"sparse_direct_solve": {}, "gmres": {"tol": 1e-12, "restart": 20}}
    x, info = getattr(pkg, name)(A, mv(b, grid=grid),
                                 **kw.get(name, {"tol": 1e-12}))
    x = mvg(x)
    return (np.asarray(x) if pkg is el else x.numpy()), info


@functools.cache
def _jax_solve(name):
    return _run(el, name, (1, 1))


@pytest.mark.parametrize("rc", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
@pytest.mark.parametrize("name", ["cg", "cgls", "gmres",
                                  "sparse_direct_solve"])
def test_solvers_match_jax(name, rc):
    x, info = _run(et, name, rc)
    xj, infoj = _jax_solve(name)
    _close(x, xj)
    assert info["converged"] and infoj["converged"]
    assert info.get("iters") == infoj.get("iters")
    rows, cols, vals, m, n, b = _system(name)
    dense = np.zeros((m, n))
    np.add.at(dense, (rows, cols), vals)
    if name == "cgls":
        r = dense.T @ (dense @ x - b)
        assert np.linalg.norm(r) < 1e-9 * np.linalg.norm(dense.T @ b)
    else:
        assert np.linalg.norm(dense @ x - b) < 1e-10 * np.linalg.norm(b)


_PACKAGES = ("sparse", "optimization", "lattice", "io")


def _exported():
    names = []
    for pkg in _PACKAGES:
        mod = getattr(el, pkg)
        names += [(pkg, n) for n in dir(mod) if not n.startswith("_")
                  and callable(getattr(mod, n))
                  and getattr(getattr(mod, n), "__module__", "").startswith(
                      f"elemental_tpu.{pkg}")]
    return names


_TOP = ["MehrotraCtrl", "lp", "qp", "socp", "soft_threshold", "svt", "bp",
        "lav", "nnls", "lasso", "svm", "rpca", "lp_affine", "qp_affine",
        "socp_affine", "ruiz_equil", "geom_equil", "symmetric_ruiz_equil",
        "lp_sparse", "lav_sparse", "bp_sparse", "cp", "ds", "en", "nmf",
        "sparse_inv_cov", "long_only_portfolio", "tv", "lll",
        "is_lll_reduced", "shortest_vector", "print_matrix",
        "write_matrix", "read_matrix", "checkpoint", "restore",
        "write_matrix_market", "read_matrix_market", "display", "spy",
        "Graph", "DistGraph", "SparseMatrix", "DistSparseMatrix", "DistMap",
        "sparse_from_coo", "dist_sparse_from_coo", "cg", "cgls", "gmres",
        "sparse_direct_solve"]


def _params(obj):
    if inspect.isclass(obj) and not hasattr(obj, "__dataclass_fields__"):
        obj = obj.__init__
    return list(inspect.signature(obj).parameters)


@pytest.mark.parametrize("pkg,name", _exported(),
                         ids=[f"{p}.{n}" for p, n in _exported()])
def test_slice_names_have_the_jax_signature(pkg, name):
    ours = getattr(getattr(et, pkg), name)
    assert _params(ours) == _params(getattr(getattr(el, pkg), name))


@pytest.mark.parametrize("name", _TOP)
def test_package_names_have_the_jax_signature(name):
    assert _params(getattr(et, name)) == _params(getattr(el, name))
