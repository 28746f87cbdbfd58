"""The port's Cuppen divide and conquer ``tridiag_eig`` against
``elemental_tpu`` on 1x1, 2x2 and 2x4 grids: the same (d, e) from a seed
go through both packages.  Eigenvalues agree to 1e-12 of the largest and
eigenvectors to 1e-10 up to each column's sign, on the replicated branch
(leaf_max = 8: three levels of batched merges) and the distributed one
(leaf_max = 4, repl_max = 16: merges past 16 run as [MC,MR] gemms), with
and without vectors; the port alone is also held to the residual and
orthogonality checks of ``tests/lapack/test_tridiag_eig.py``."""
import functools
import importlib

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et

#: the two packages' modules (``tridiag_eig`` in each ``lapack`` namespace
#: is rebound to the function)
jte = importlib.import_module("elemental_tpu.lapack.tridiag_eig")
tte = importlib.import_module("elemental_tpu_torch.lapack.tridiag_eig")

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]
N = 64
BRANCHES = {"replicated": dict(leaf_max=8),
            "distributed": dict(leaf_max=4, repl_max=16)}


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _de(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n - 1)


def _trid(d, e):
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


def _signed_like(Z, Zref):
    """Z with each column's sign chosen to match Zref's."""
    s = np.sign(np.sum(Z * Zref, axis=0))
    s[s == 0] = 1
    return Z * s


@functools.lru_cache(maxsize=None)
def _reference(branch, rc):
    d, e = _de()
    w, Z = jte.tridiag_eig(d, e, grid=jgrid(*rc), vectors=True,
                           **BRANCHES[branch])
    return np.asarray(w), np.asarray(el.to_global(Z))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_tridiag_eig_matches_jax(branch, rc):
    d, e = _de()
    jw, jZ = _reference(branch, rc)
    w, Z = tte.tridiag_eig(torch.as_tensor(d), torch.as_tensor(e),
                           grid=tgrid(*rc), vectors=True, **BRANCHES[branch])
    assert isinstance(Z, et.DistMatrix) and Z.gshape == (N, N)
    assert w.dtype == torch.float64 and Z.dtype == torch.float64
    np.testing.assert_allclose(w.numpy(), jw, rtol=0,
                               atol=1e-12 * np.abs(jw).max())
    Zg = et.to_global(Z).numpy()
    np.testing.assert_allclose(_signed_like(Zg, jZ), jZ, rtol=0, atol=1e-10)
    # the oracle checks of the JAX package's tests
    T = _trid(d, e)
    assert np.linalg.norm(T @ Zg - Zg * w.numpy()[None, :]) \
        / np.linalg.norm(T) < 1e-10
    assert np.linalg.norm(Zg.T @ Zg - np.eye(N)) < 1e-10 * N


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_values_only_matches_jax(branch):
    d, e = _de(seed=1)
    jw = np.asarray(jte.tridiag_eig(d, e, vectors=False, **BRANCHES[branch]))
    w = tte.tridiag_eig(torch.as_tensor(d), torch.as_tensor(e),
                        vectors=False, **BRANCHES[branch])
    np.testing.assert_allclose(w.numpy(), jw, rtol=0,
                               atol=1e-12 * np.abs(jw).max())
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(_trid(d, e)),
                               rtol=0, atol=1e-10)


def test_replicated_without_a_grid_returns_a_tensor():
    d, e = _de()
    w, Z = tte.tridiag_eig(torch.as_tensor(d), torch.as_tensor(e),
                           leaf_max=8)
    assert isinstance(Z, torch.Tensor) and Z.shape == (N, N)
    jw, jZ = _reference("replicated", (1, 1))
    np.testing.assert_allclose(_signed_like(Z.numpy(), jZ), jZ, rtol=0,
                               atol=1e-10)
    with pytest.raises(ValueError):
        tte.tridiag_eig(torch.as_tensor(d), torch.as_tensor(e),
                        **BRANCHES["distributed"])


def test_known_spectra_and_zero_couplings():
    """tridiag(1, 2, 1) (eigenvalues 2 - 2 cos(k pi / (n + 1))), the
    Wilkinson W21+ (close pairs) and zero couplings (no 0/0)."""
    n = 128
    w = tte.tridiag_eig(torch.full((n,), 2.0, dtype=torch.float64),
                        torch.ones(n - 1, dtype=torch.float64),
                        vectors=False, leaf_max=16)
    k = np.arange(1, n + 1)
    np.testing.assert_allclose(np.sort(w.numpy()),
                               np.sort(2.0 - 2.0 * np.cos(k * np.pi / (n + 1))),
                               rtol=0, atol=1e-10)
    m = 10
    d = np.abs(np.arange(2 * m + 1) - m).astype(np.float64)
    e = np.ones(2 * m)
    w, Z = tte.tridiag_eig(torch.as_tensor(d), torch.as_tensor(e),
                           leaf_max=8)
    T = _trid(d, e)
    Zn = Z.numpy()
    assert np.linalg.norm(T @ Zn - Zn * w.numpy()[None, :]) \
        / np.linalg.norm(T) < 1e-10
    assert np.linalg.norm(Zn.T @ Zn - np.eye(2 * m + 1)) < 1e-10 * (2 * m + 1)
    d = np.linspace(-3, 5, 96)
    w = tte.tridiag_eig(torch.as_tensor(d), torch.zeros(95, dtype=torch.float64),
                        vectors=False, leaf_max=16)
    np.testing.assert_allclose(np.sort(w.numpy()), np.sort(d), rtol=0,
                               atol=1e-10)


def test_float32_input_keeps_float32_outputs():
    """Storage dtype float32: w and Z come back float32 (the secular stage
    runs in float64 either way)."""
    d, e = _de()
    w, Z = tte.tridiag_eig(torch.as_tensor(d, dtype=torch.float32),
                           torch.as_tensor(e, dtype=torch.float32),
                           grid=tgrid(1, 1), **BRANCHES["distributed"])
    assert w.dtype == torch.float32 and Z.dtype == torch.float32
    T = _trid(d.astype(np.float32).astype(np.float64),
              e.astype(np.float32).astype(np.float64))
    Zg = et.to_global(Z).numpy().astype(np.float64)
    assert np.linalg.norm(T @ Zg - Zg * w.numpy()[None, :]) \
        / np.linalg.norm(T) < 1e-5
