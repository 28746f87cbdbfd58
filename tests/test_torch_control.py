"""The port's control solvers (``control/core.py``: ``sylvester``,
``lyapunov``, ``riccati``, all on the matrix sign function) against
``elemental_tpu``: the inputs of ``tests/control/test_control.py`` (made
from the same seeds with numpy) go through both packages, the JAX package
once per input on a 1x1 grid and the port on 1x1, 2x2 and 2x4 grids.
Solutions agree to 1e-12 of the largest entry and meet the JAX tests'
residual bounds and scipy's solutions.

The JAX references run on a 1x1 JAX grid: on its 8 virtual CPU devices a
JAX call that dispatches many small sharded computations in turn can
starve XLA's in-process all-reduce rendezvous when the host is loaded
(several test workers), which aborts the process after 40 s
(``rendezvous.cc``: "Termination timeout ... exceeded"); one device has
no rendezvous.
"""
import functools

import jax
import numpy as np
import pytest
import scipy.linalg

import elemental_tpu as el
import elemental_tpu_torch as et

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]


def _stable(rng, n):
    A = rng.normal(size=(n, n))
    return A - (np.abs(np.linalg.eigvals(A).real).max() + 1) * np.eye(n)


def _inputs(name):
    if name == "sylvester":
        rng = np.random.default_rng(0)
        A, B = _stable(rng, 12), _stable(rng, 8)
        return A, B, rng.normal(size=(12, 8))
    if name == "lyapunov":
        rng = np.random.default_rng(1)
        A = _stable(rng, 12)
        C = rng.normal(size=(12, 12))
        return A, C + C.T
    rng = np.random.default_rng(2)
    n, k = 8, 3
    A = rng.normal(size=(n, n))
    B = rng.normal(size=(n, k))
    Q = rng.normal(size=(n, n))
    return A, B @ B.T, Q @ Q.T / n + np.eye(n), B


def _args(name):
    x = _inputs(name)
    return x[:3] if name == "riccati" else x


@functools.lru_cache(maxsize=None)
def _jax(name):
    grid = el.Grid(jax.devices()[:1], height=1)
    out = getattr(el, name)(*[el.from_global(F, el.MC, el.MR, grid=grid)
                              for F in _args(name)])
    return np.asarray(el.to_global(out))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("name", ["sylvester", "lyapunov", "riccati"])
def test_control_matches_jax(rc, name):
    grid = et.Grid(*rc, device="cpu")
    X = et.to_global(getattr(et, name)(
        *[et.from_global(F, et.MC, et.MR, grid=grid)
          for F in _args(name)])).numpy()
    want = _jax(name)
    tol = 1e-12
    np.testing.assert_allclose(X, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1))
    # tests/control/test_control.py's bounds
    if name == "sylvester":
        A, B, C = _inputs(name)
        assert np.linalg.norm(A @ X + X @ B - C) / np.linalg.norm(C) < 1e-12
        Xs = scipy.linalg.solve_sylvester(A, B, C)
        assert np.linalg.norm(X - Xs) / np.linalg.norm(Xs) < 1e-12
    elif name == "lyapunov":
        A, C = _inputs(name)
        assert np.linalg.norm(A @ X + X @ A.T - C) / np.linalg.norm(C) \
            < 1e-12
    else:
        A, G, Q, B = _inputs(name)
        r = A.T @ X + X @ A + Q - X @ G @ X
        assert np.linalg.norm(r) / np.linalg.norm(Q) < 1e-10
        Xs = scipy.linalg.solve_continuous_are(A, B, Q, np.eye(B.shape[1]))
        assert np.linalg.norm(X - Xs) / np.linalg.norm(Xs) < 1e-10
