"""The whole slice: ``hpd_solve`` (Cholesky + the two triangular sweeps)
through the port on 1x1, 2x2 and 2x4 grids and through ``elemental_tpu``
on a 1x1 grid (once per module), from the same numpy inputs, at n = 40,
nb = 16 (float64, rtol 1e-12)."""

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from .torch_shared_ref import shared_cache

GRIDS = [(1, 1), (2, 2), (2, 4)]


def _hpd(n, seed):
    G = np.random.default_rng(seed).normal(size=(n, n))
    return G @ G.T / n + n * np.eye(n)


@shared_cache
def _jax_hpd_solve(uplo):
    n, nrhs = 40, 6
    F = _hpd(n, seed=7)
    B = np.random.default_rng(8).normal(size=(n, nrhs))
    jg = el.Grid(jax.devices()[:1], height=1)
    return np.asarray(el.to_global(el.hpd_solve(
        el.from_global(F, el.MC, el.MR, jg),
        el.from_global(B, el.MC, el.MR, jg), uplo=uplo, nb=16)))


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_hpd_solve_slice_matches_jax(rc, uplo):
    """The whole slice: HPD solve at n = 40, nb = 16 through both
    packages."""
    n, nrhs = 40, 6
    F = _hpd(n, seed=7)
    B = np.random.default_rng(8).normal(size=(n, nrhs))
    tg = et.Grid(*rc, device="cpu")
    tX = et.hpd_solve(et.from_global(F, et.MC, et.MR, tg),
                      et.from_global(B, et.MC, et.MR, tg), uplo=uplo, nb=16)
    want = _jax_hpd_solve(uplo)
    got = et.to_global(tX).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    assert np.linalg.norm(F @ got - B) < 1e-12 * np.linalg.norm(B)



@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_hpd_solve_leaves_inputs_untouched(rc):
    """PyTorch updates in place where JAX never does: neither the
    factorization nor the two triangular sweeps may write into the
    caller's A or B."""
    tg = et.Grid(*rc, device="cpu")
    A = et.from_global(_hpd(24, seed=9), et.MC, et.MR, tg)
    B = et.from_global(np.random.default_rng(10).normal(size=(24, 3)),
                       et.MC, et.MR, tg)
    a0, b0 = A.local.clone(), B.local.clone()
    et.hpd_solve(A, B, nb=8)
    assert torch.equal(A.local, a0) and torch.equal(B.local, b0)
