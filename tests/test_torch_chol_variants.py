"""The port's pivoted Cholesky (``pstrf``) and rank-k Cholesky
modification (mirroring the pivoted / modified cases of
``tests/lapack/test_variants.py``), held against the JAX package.

``cholesky_pivoted`` must detect the same rank, pick the JAX package's
pivots for the factored columns (exactly; ties break on the first index,
as ``jnp.argmax`` does) and give the same factor there to 1e-12; past
the rank the residual diagonal is roundoff and only the reconstruction
is held.  ``cholesky_mod`` must give the JAX factor to 1e-12 and raise
on an indefinite downdate.  Each
JAX reference is computed once per module on a 1x1 JAX grid; the port
runs on 1x1, 2x2 and 2x4."""

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from .torch_shared_ref import shared_cache

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def _t(A):
    return et.to_global(A).numpy()


def _case(name):
    """(matrix, tol) of each pivoted case; every real case has order 12,
    so the JAX reference compiles one loop for them."""
    rng = np.random.default_rng(4)
    n = 12
    if name == "hpd":
        G = rng.normal(size=(n, n))
        return G @ G.T + n * np.eye(n), 0.0
    if name == "rankdef":
        G = np.random.default_rng(5).normal(size=(n, 5))
        return G @ G.T, 1e-10
    if name == "scaled_identity":
        return 1e-20 * np.eye(n), 1e-6
    if name == "ties":
        # equal diagonal entries everywhere: every pick is a tie
        return np.eye(n) + 0.1 * np.ones((n, n)), 0.0
    if name == "complex":
        G = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
        return G @ G.conj().T + n * np.eye(n), 0.0
    raise KeyError(name)


@shared_cache
def _jax_pivoted(name):
    F, tol = _case(name)
    L, perm, rank = el.cholesky_pivoted(
        el.from_global(F, el.MC, el.MR, grid=jgrid(1, 1)), tol=tol)
    return np.asarray(el.to_global(L)), np.asarray(perm), int(rank)


@pytest.mark.parametrize("name", ["hpd", "rankdef", "scaled_identity",
                                  "ties", "complex"])
@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_cholesky_pivoted_equals_jax(rc, name):
    F, tol = _case(name)
    L, perm, rank = et.cholesky_pivoted(
        et.from_global(F, et.MC, et.MR, grid=tgrid(*rc)), tol=tol)
    jL, jperm, jrank = _jax_pivoted(name)
    p = perm.numpy()
    assert int(rank) == jrank and rank.dtype == torch.int64
    # past the detected rank the residual diagonal is roundoff, so the
    # order of the zeroed columns is noise: compare the factored columns,
    # their rows taken back to the input's order
    np.testing.assert_array_equal(p[:jrank], jperm[:jrank])
    Lg = _t(L)
    Lu, jLu = np.empty_like(Lg), np.empty_like(jL)
    Lu[p], jLu[jperm] = Lg, jL
    np.testing.assert_allclose(Lu[:, :jrank], jLu[:, :jrank], rtol=0,
                               atol=1e-12 * max(np.abs(jL).max(), 1e-300))
    assert np.allclose(Lg, np.tril(Lg))
    scale = np.abs(F).max()
    np.testing.assert_allclose(Lg @ Lg.conj().T, F[np.ix_(p, p)], rtol=0,
                               atol=1e-9 * scale)
    if name == "hpd":
        assert jrank == 12
        d = np.diag(Lg)
        assert np.all(d[:-1] >= d[1:] - 1e-12)     # non-increasing pivots
        L0 = _t(et.cholesky(et.from_global(F[np.ix_(p, p)], et.MC, et.MR,
                                           grid=tgrid(*rc))))
        np.testing.assert_allclose(Lg, L0, atol=1e-8)
    if name == "rankdef":
        assert jrank == 5 and not Lg[:, 5:].any()
    if name == "ties":
        np.testing.assert_array_equal(p, np.arange(12))


def _mod_inputs():
    rng = np.random.default_rng(9)
    n, k = 22, 3
    G0 = rng.normal(size=(n, n))
    return G0 @ G0.T + n * np.eye(n), rng.normal(size=(n, k))


@shared_cache
def _jax_mod():
    F, V = _mod_inputs()
    g = jgrid(1, 1)
    L = el.cholesky(el.from_global(F, el.MC, el.MR, grid=g))
    Vd = el.from_global(V, el.MC, el.MR, grid=g)
    L2 = el.cholesky_mod(L, Vd, 1.5)
    L3 = el.cholesky_mod(L2, Vd, -1.5)
    return np.asarray(el.to_global(L2)), np.asarray(el.to_global(L3))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_cholesky_mod_up_and_downdate_equal_jax(rc):
    F, V = _mod_inputs()
    g = tgrid(*rc)
    L = et.cholesky(et.from_global(F, et.MC, et.MR, grid=g))
    Vd = et.from_global(V, et.MC, et.MR, grid=g)
    L2 = et.cholesky_mod(L, Vd, 1.5)
    L3 = et.cholesky_mod(L2, Vd, -1.5)
    jL2, jL3 = _jax_mod()
    np.testing.assert_allclose(_t(L2), jL2, rtol=0, atol=1e-12)
    np.testing.assert_allclose(_t(L3), jL3, rtol=0, atol=1e-12)
    L2g, L3g = _t(L2), _t(L3)
    np.testing.assert_allclose(L2g @ L2g.T, F + 1.5 * V @ V.T, atol=1e-9)
    np.testing.assert_allclose(L3g @ L3g.T, F, atol=1e-8)
    np.testing.assert_allclose(L3g, _t(L), atol=1e-8)
    assert np.allclose(L2g, np.tril(L2g))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_cholesky_mod_refusals(rc):
    g = tgrid(*rc)
    L = et.cholesky(et.from_global(np.eye(6), et.MC, et.MR, grid=g))
    V = np.zeros((6, 1))
    V[0] = 2.0
    with pytest.raises(ValueError, match="indefinite"):
        et.cholesky_mod(L, et.from_global(V, et.MC, et.MR, grid=g), -1.0)
    with pytest.raises(ValueError):
        et.cholesky_mod(L, et.from_global(np.ones((5, 1)), et.MC, et.MR,
                                          grid=g))
    Lc = et.from_global(np.eye(6, dtype=complex), et.MC, et.MR, grid=g)
    with pytest.raises(NotImplementedError):
        et.cholesky_mod(Lc, et.from_global(V.astype(complex), et.MC, et.MR,
                                           grid=g))
    with pytest.raises(ValueError):
        et.cholesky_pivoted(et.from_global(np.ones((4, 3)), et.MC, et.MR,
                                           grid=g))
