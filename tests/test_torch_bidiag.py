"""The port's ``bidiag`` / ``apply_p_bidiag`` and ``hessenberg`` /
``apply_q_hessenberg`` against ``elemental_tpu``: the same numpy inputs
from a seed go through both packages, the JAX package once per input on a
1x1 grid and the port on 1x1, 2x2 and 2x4 grids.  d, e, the taus and the
packed factor agree to 1e-13 of their largest entry; the apply functions
are fed the JAX package's factors (through ``from_storage``) and agree to
1e-13; the port's own factors meet ``tests/lapack/test_condense.py``'s
oracles.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.lapack import condense as jcond

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]
#: case -> (shape, nb, complex, seed): tests/lapack/test_condense.py's
#: tall, square-full-panel and complex inputs
BIDIAG = {"tall": ((24, 16), 8, False, 20), "square": ((16, 16), 16, False, 21),
          "complex": ((20, 12), 4, True, 22)}


def _jg(F):
    return el.from_global(F, el.MC, el.MR,
                          grid=el.Grid(jax.devices()[:1], height=1))


def _tgrid(rc):
    return et.Grid(*rc, device="cpu")


def _tg(F, rc):
    return et.from_global(F, et.MC, et.MR, grid=_tgrid(rc))


def _t(A):
    return et.to_global(A).numpy()


def _close(got, want, tol=1e-13):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _bidiag_input(case):
    (m, n), _, cplx, seed = BIDIAG[case]
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(m, n))
    return F + 1j * rng.normal(size=(m, n)) if cplx else F


@functools.lru_cache(maxsize=None)
def _jax_bidiag(case):
    Ap, d, e, tauq, taup = jcond.bidiag(_jg(_bidiag_input(case)),
                                        nb=BIDIAG[case][1])
    return Ap, tuple(np.asarray(x) for x in (d, e, tauq, taup))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("case", list(BIDIAG))
def test_bidiag_matches_jax(rc, case):
    F = _bidiag_input(case)
    m, n = F.shape
    nb = BIDIAG[case][1]
    Ap, d, e, tauq, taup = et.bidiag(_tg(F, rc), nb=nb)
    jAp, jvec = _jax_bidiag(case)
    for got, want in zip((d, e, tauq, taup), jvec):
        assert got.shape == want.shape
        _close(got.numpy(), want)
    assert not d.is_complex() and not e.is_complex()
    _close(_t(Ap), np.asarray(el.to_global(jAp)))
    # tests/lapack/test_condense.py::_check_bidiag on the port's factors
    B = np.zeros((m, n), F.dtype)
    B[:n, :n] = np.diag(d.numpy().astype(F.dtype)) \
        + np.diag(e.numpy().astype(F.dtype), 1)
    Q = _t(et.apply_q(Ap, tauq, _tg(np.eye(m, dtype=F.dtype), rc),
                      orient="N", nb=nb))
    P = _t(et.apply_p_bidiag(Ap, taup, _tg(np.eye(n, dtype=F.dtype), rc),
                             orient="N", nb=nb))
    assert np.linalg.norm(Q.conj().T @ Q - np.eye(m)) < 1e-12 * m
    assert np.linalg.norm(P.conj().T @ P - np.eye(n)) < 1e-12 * n
    assert np.linalg.norm(Q @ B @ P.conj().T - F) / np.linalg.norm(F) < 1e-13
    sa = np.linalg.svd(F, compute_uv=False)
    sb = np.linalg.svd(B, compute_uv=False)
    assert np.linalg.norm(sa - sb) < 1e-12 * max(sa[0], 1)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("orient", ["N", "C"])
def test_apply_p_bidiag_matches_jax(rc, orient):
    """Fed the JAX package's (Ap, taup) through ``from_storage``."""
    case = "complex"
    jAp, (_, _, _, jtaup) = _jax_bidiag(case)
    m, n = jAp.gshape
    nb = BIDIAG[case][1]
    rng = np.random.default_rng(30)
    X = rng.normal(size=(n, 5)) + 1j * rng.normal(size=(n, 5))
    jgrid = el.Grid(jax.devices()[: rc[0] * rc[1]], height=rc[0])
    jA = el.from_global(np.asarray(el.to_global(jAp)), el.MC, el.MR,
                        grid=jgrid)
    want = jcond.apply_p_bidiag(jA, jnp.asarray(jtaup),
                                el.from_global(X, el.MC, el.MR, grid=jgrid),
                                orient=orient, nb=nb)
    tA = et.from_storage(np.asarray(jA.local), (m, n), et.MC, et.MR,
                         grid=_tgrid(rc))
    got = et.apply_p_bidiag(tA, torch.tensor(jtaup), _tg(X, rc),
                            orient=orient, nb=nb)
    np.testing.assert_allclose(et.storage_numpy(got), np.asarray(want.local),
                               rtol=0, atol=1e-13 * np.abs(X).max())


@functools.lru_cache(maxsize=None)
def _hess_input(cplx):
    rng = np.random.default_rng(7)
    A = rng.standard_normal((21, 21))
    return A + 1j * rng.standard_normal((21, 21)) if cplx else A


@functools.lru_cache(maxsize=None)
def _jax_hessenberg(cplx):
    H, Qp, tau = jcond.hessenberg(_jg(_hess_input(cplx)))
    return (np.asarray(el.to_global(H)), np.asarray(el.to_global(Qp)),
            np.asarray(tau))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("cplx", [False, True], ids=["f64", "c128"])
def test_hessenberg_matches_jax(rc, cplx):
    A = _hess_input(cplx)
    n = A.shape[0]
    H, Qp, tau = et.hessenberg(_tg(A, rc))
    jH, jQp, jtau = _jax_hessenberg(cplx)
    _close(_t(H), jH)
    _close(_t(Qp), jQp)
    _close(tau.numpy(), jtau)
    # tests/lapack/test_condense.py::test_hessenberg on the port's factors
    Hg = _t(H)
    assert np.abs(np.tril(Hg, -2)).max() < 1e-12
    Q = _t(et.apply_q_hessenberg(Qp, tau, _tg(np.eye(n, dtype=A.dtype), rc)))
    assert np.linalg.norm(A - Q @ Hg @ Q.conj().T) / np.linalg.norm(A) < 1e-12
    assert np.linalg.norm(np.eye(n) - Q.conj().T @ Q) < 1e-12
    # and both orientations against the JAX apply on the JAX factors
    X = np.random.default_rng(31).normal(size=(n, 4)).astype(A.dtype)
    for orient in ("N", "C"):
        want = jcond.apply_q_hessenberg(
            _jg(jQp), jnp.asarray(jtau), _jg(X), orient=orient)
        got = et.apply_q_hessenberg(_tg(jQp, rc), torch.tensor(jtau),
                                    _tg(X, rc), orient=orient)
        _close(_t(got), np.asarray(el.to_global(want)))


def test_small_and_refused_inputs():
    A = _tg(np.array([[2.0, 1.0], [3.0, 4.0]]), (1, 1))
    H, Qp, tau = et.hessenberg(A)
    assert H is A and tau.shape == (1,)
    with pytest.raises(ValueError, match="m >= n"):
        et.bidiag(_tg(np.ones((3, 5)), (1, 1)))
    with pytest.raises(ValueError, match="square"):
        et.hessenberg(_tg(np.ones((3, 5)), (1, 1)))
