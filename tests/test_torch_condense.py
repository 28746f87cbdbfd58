"""The port's ``hermitian_tridiag`` and ``apply_q_herm_tridiag`` against
``elemental_tpu`` on 1x1, 2x2 and 2x4 grids: the same numpy inputs from a
seed go through both packages.  d, e, tau and the packed storage ``Ap``
(both triangles: the stale upper one too) agree to 1e-12 of their largest
entry; ``apply_q_herm_tridiag`` is fed the JAX package's ``(Ap, tau)``
through ``from_storage``, so it is held on its own; the port's own
factors reproduce A (``tests/lapack/test_condense.py``'s residual and
orthogonality bounds)."""
import functools
import importlib

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.matrices.basic import identity as jax_identity

#: the JAX package's condense module
jcond = importlib.import_module("elemental_tpu.lapack.condense")

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]
N, NB = 24, 8
CPLX = np.complex128


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _herm(dtype, seed=0, n=N):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    if np.issubdtype(dtype, np.complexfloating):
        A = A + 1j * rng.standard_normal((n, n))
    return ((A + A.conj().T) / 2).astype(dtype)


def _close(got, want, tol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


@functools.lru_cache(maxsize=None)
def _reference(rc, dtype, uplo="L"):
    """The JAX package's (A, Ap, d, e, tau) on grid ``rc``."""
    A = _herm(dtype)
    if uplo == "U":
        A[np.tril_indices(N, -1)] = 99.0       # 'U' must read the upper only
    Ap, d, e, tau = jcond.hermitian_tridiag(
        el.from_global(A, el.MC, el.MR, jgrid(*rc)), uplo=uplo, nb=NB)
    return A, Ap, np.asarray(d), np.asarray(e), tau


@pytest.mark.parametrize("rc,dtype,uplo", [
    ((1, 1), np.float64, "L"), ((2, 2), np.float64, "L"),
    ((2, 4), np.float64, "L"), ((1, 1), CPLX, "L"), ((2, 4), np.float64, "U")],
    ids=["1x1", "2x2", "2x4", "1x1-c128", "2x4-upper"])
def test_hermitian_tridiag_matches_jax(rc, dtype, uplo):
    A, jAp, jd, je, jtau = _reference(rc, dtype, uplo)
    tA = et.from_global(A, et.MC, et.MR, tgrid(*rc))
    before = tA.local.clone()
    Ap, d, e, tau = et.hermitian_tridiag(tA, uplo=uplo, nb=NB)
    assert torch.equal(tA.local, before)            # the input is untouched
    assert d.dtype == torch.float64 and e.dtype == torch.float64
    assert tau.dtype == tA.dtype
    _close(d.numpy(), jd)
    _close(e.numpy(), je)
    _close(tau.numpy(), np.asarray(jtau))
    _close(et.storage_numpy(Ap), np.asarray(jAp.local))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("orient", ["N", "C"])
def test_apply_q_fed_the_jax_factors_matches_jax(rc, orient):
    A, jAp, _, _, jtau = _reference(rc, np.float64)
    B = np.random.default_rng(1).standard_normal((N, 5))
    jB = el.from_global(B, el.MC, el.MR, jgrid(*rc))
    want = jcond.apply_q_herm_tridiag(jAp, jtau, jB, orient=orient, nb=NB)
    tAp = et.from_storage(np.asarray(jAp.local), (N, N), et.MC, et.MR,
                          grid=tgrid(*rc))
    tB = et.from_global(B, et.MC, et.MR, tgrid(*rc))
    got = et.apply_q_herm_tridiag(tAp, torch.as_tensor(np.array(jtau)), tB,
                                  orient=orient, nb=NB)
    _close(et.storage_numpy(got), np.asarray(want.local))


@pytest.mark.parametrize("rc,dtype", [((1, 1), np.float64), ((2, 2), np.float64),
                                      ((2, 4), np.float64), ((1, 1), CPLX)],
                         ids=["1x1", "2x2", "2x4", "1x1-c128"])
def test_port_factors_reproduce_a(rc, dtype):
    """||A - Q T Q^H|| / ||A|| < 1e-12 and ||I - Q^H Q|| < 1e-12 with Q
    from the port's own back-transform of the identity, and T's
    eigenvalues equal A's."""
    A = _herm(dtype)
    g = tgrid(*rc)
    Ap, d, e, tau = et.hermitian_tridiag(et.from_global(A, et.MC, et.MR, g),
                                         nb=NB)
    T = np.diag(d.numpy()) + np.diag(e.numpy(), -1) + np.diag(e.numpy(), 1)
    Q = et.to_global(et.apply_q_herm_tridiag(
        Ap, tau, et.identity(N, grid=g, dtype=Ap.dtype), nb=NB)).numpy()
    assert np.linalg.norm(A - Q @ T @ Q.conj().T) / np.linalg.norm(A) < 1e-12
    assert np.linalg.norm(np.eye(N) - Q.conj().T @ Q) < 1e-12
    np.testing.assert_allclose(np.linalg.eigvalsh(T), np.linalg.eigvalsh(A),
                               rtol=1e-10, atol=1e-10)


def test_explicit_q_matches_jax_on_a_ragged_size():
    """n = 37 (nb = 8: a ragged final panel that also extracts the last
    diagonal entry), complex: Q from the identity agrees with the JAX
    package's to 1e-12."""
    n = 37
    A = _herm(CPLX, seed=5, n=n)
    jAp, _, _, jtau = jcond.hermitian_tridiag(
        el.from_global(A, el.MC, el.MR, jgrid(1, 1)), nb=NB)
    jQ = jcond.apply_q_herm_tridiag(jAp, jtau, jax_identity(
        n, grid=jgrid(1, 1), dtype=CPLX), nb=NB)
    g = tgrid(1, 1)
    Ap, d, e, tau = et.hermitian_tridiag(et.from_global(A, et.MC, et.MR, g),
                                         nb=NB)
    tQ = et.apply_q_herm_tridiag(Ap, tau, et.identity(n, grid=g, dtype=Ap.dtype),
                                 nb=NB)
    _close(et.to_global(tQ).numpy(), np.asarray(el.to_global(jQ)))


def test_small_orders():
    """n = 0, 1, 2: the early returns and the one-reflector panel."""
    g = tgrid(1, 1)
    Ap, d, e, tau = et.hermitian_tridiag(
        et.from_global(np.zeros((0, 0)), et.MC, et.MR, g))
    assert d.shape == e.shape == tau.shape == (0,)
    Ap, d, e, tau = et.hermitian_tridiag(
        et.from_global(np.array([[3.0]]), et.MC, et.MR, g))
    assert d.tolist() == [3.0] and e.shape == (0,)
    A = np.array([[2.0, -1.0], [-1.0, 5.0]])
    Ap, d, e, tau = et.hermitian_tridiag(et.from_global(A, et.MC, et.MR, g))
    T = np.diag(d.numpy()) + np.diag(e.numpy(), -1) + np.diag(e.numpy(), 1)
    np.testing.assert_allclose(np.linalg.eigvalsh(T), np.linalg.eigvalsh(A),
                               rtol=1e-14)
