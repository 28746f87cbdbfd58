"""The port's Euclidean minimization solvers (``lapack/euclidean_min.py``:
``ridge``, ``tikhonov``, ``lse``, ``glm``) against ``elemental_tpu``: the
inputs of ``tests/lapack/test_euclidean_min.py`` (made from the same
seeds with numpy) go through both packages, the JAX package once per
input on a 1x1 grid and the port on 1x1, 2x2 and 2x4 grids.  Solutions
agree to 1e-12 of the largest entry and meet the JAX tests' closed-form
bounds.

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

import elemental_tpu as el
import elemental_tpu_torch as et

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]


def _inputs(name):
    """tests/lapack/test_euclidean_min.py's inputs, by test."""
    if name == "ridge":
        rng = np.random.default_rng(0)
        return rng.normal(size=(20, 8)), rng.normal(size=(20, 2))
    if name == "tikhonov":
        rng = np.random.default_rng(1)
        return (rng.normal(size=(20, 8)), rng.normal(size=(20, 1)),
                rng.normal(size=(5, 8)))
    if name == "lse":
        rng = np.random.default_rng(2)
        return (rng.normal(size=(20, 8)), rng.normal(size=(20, 1)),
                rng.normal(size=(3, 8)), rng.normal(size=(3, 1)))
    if name == "glm":
        rng = np.random.default_rng(3)
        return (rng.normal(size=(12, 4)), rng.normal(size=(12, 12)),
                rng.normal(size=(12, 1)))
    if name == "lse_complex":
        rng = np.random.default_rng(4)

        def c(*shape):
            return rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return c(12, 5), c(12, 1), c(2, 5), c(2, 1)
    raise KeyError(name)


def _run(pkg, name, dm):
    args = [dm(x) for x in _inputs(name)]
    if name == "ridge":
        return (pkg.ridge(*args, 1.5),)
    if name == "tikhonov":
        return (pkg.tikhonov(*args),)
    if name.startswith("lse"):
        return (pkg.lse(*args),)
    return pkg.glm(*args)


@functools.lru_cache(maxsize=None)
def _jax(name):
    grid = el.Grid(jax.devices()[:1], height=1)
    out = _run(el, name, lambda F: el.from_global(F, el.MC, el.MR,
                                                  grid=grid))
    return tuple(np.asarray(el.to_global(x)) for x in out)


def _agree(got, want, tol=1e-12):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("name", ["ridge", "tikhonov", "lse", "glm",
                                  "lse_complex"])
def test_euclidean_min_matches_jax(rc, name):
    grid = et.Grid(*rc, device="cpu")
    out = _run(et, name, lambda F: et.from_global(F, et.MC, et.MR,
                                                  grid=grid))
    got = tuple(et.to_global(x).numpy() for x in out)
    for g, j in zip(got, _jax(name)):
        _agree(g, j)
    # tests/lapack/test_euclidean_min.py's closed forms and bounds
    if name == "ridge":
        A, b = _inputs(name)
        ref = np.linalg.solve(A.T @ A + 1.5 ** 2 * np.eye(8), A.T @ b)
        assert np.linalg.norm(got[0] - ref) < 1e-12
    elif name == "tikhonov":
        A, b, G = _inputs(name)
        ref = np.linalg.solve(A.T @ A + G.T @ G, A.T @ b)
        assert np.linalg.norm(got[0] - ref) < 1e-12
    elif name.startswith("lse"):
        A, b, C, d = _inputs(name)
        n, p = A.shape[1], C.shape[0]
        K = np.block([[A.conj().T @ A, C.conj().T],
                      [C, np.zeros((p, p), A.dtype)]])
        ref = np.linalg.solve(K, np.vstack([A.conj().T @ b, d]))[:n]
        assert np.linalg.norm(got[0] - ref) < 1e-11
        assert np.linalg.norm(C @ got[0] - d) < 1e-12
    else:
        A, B, d = _inputs(name)
        x, y = got
        assert np.linalg.norm(A @ x + B @ y - d) < 1e-12
        Wi = np.linalg.inv(B @ B.T)
        ref = np.linalg.solve(A.T @ Wi @ A, A.T @ Wi @ d)
        assert np.linalg.norm(x - ref) < 1e-10
