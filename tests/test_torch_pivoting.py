"""The port's pivoted factorizations, ``qr_col_piv`` (Businger-Golub) and
``lu_full_pivot`` (complete pivoting), against ``elemental_tpu``: the
inputs of ``tests/lapack/test_qr.py`` and ``tests/lapack/test_variants.py``
(made from the same seeds with numpy) go through both packages, the JAX
package once per input on a 1x1 grid and the port on 1x1, 2x2 and 2x4
grids.  ``jpvt``, ``rperm`` and ``cperm`` are equal exactly; the packed
factors and tau agree to 1e-12 of the largest entry; every result meets
the JAX tests' own oracles.  On the rank-4 input the pivots past the
numerical rank follow rounding noise, so there they are held up to the
rank.

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
from elemental_tpu.lapack.qr import qr_col_piv as j_qr_col_piv
from elemental_tpu.lapack.lu import lu_full_pivot as j_lu_full_pivot

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]


def _jg(F):
    return el.from_global(F, el.MC, el.MR,
                          grid=el.Grid(jax.devices()[:1], height=1))


def _tg(F, rc):
    return et.from_global(F, et.MC, et.MR, grid=et.Grid(*rc, device="cpu"))


def _t(A):
    return et.to_global(A).numpy()


def _agree(got, want, tol=1e-12):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1))


def _cpqr_input(name):
    """tests/lapack/test_qr.py::test_qr_col_piv's three calls (one seeded
    stream), ::test_qr_col_piv_rank_revealing and
    ::test_qr_col_piv_records_blocking; (input, nb)."""
    if name == "rank4":
        rng = np.random.default_rng(32)
        return rng.normal(size=(16, 4)) @ rng.normal(size=(4, 12)), 4
    if name == "records":
        return np.random.default_rng(33).normal(size=(16, 12)), 4
    rng = np.random.default_rng(31)
    tall = rng.normal(size=(16, 12))
    square = rng.normal(size=(12, 12))
    cplx = rng.normal(size=(12, 8)) + 1j * rng.normal(size=(12, 8))
    return {"tall": (tall, 4), "square": (square, 12),
            "complex": (cplx, 4)}[name]


@functools.lru_cache(maxsize=None)
def _jax_cpqr(name):
    F, nb = _cpqr_input(name)
    Ap, tau, jpvt = j_qr_col_piv(_jg(F), nb=nb)
    return np.asarray(el.to_global(Ap)), np.asarray(tau), np.asarray(jpvt)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("name", ["tall", "square", "complex", "rank4",
                                  "records"])
def test_qr_col_piv_matches_jax(rc, name):
    F, nb = _cpqr_input(name)
    m, n = F.shape
    A = _tg(F, rc)
    Ap, tau, jpvt = et.qr_col_piv(A, nb=nb)
    jAp, jtau, jjp = _jax_cpqr(name)
    jp = jpvt.numpy()
    if name == "rank4":
        # past the numerical rank (4) every remaining column norm is
        # rounding noise (~1e-15), so the pivot order there depends on the
        # order of the sums and is not defined: hold the pivots, the
        # reflectors and R's leading block up to the rank
        r = 4
        np.testing.assert_array_equal(jp[:r], jjp[:r])
        _agree(_t(Ap)[:, :r], jAp[:, :r])
        _agree(tau.numpy()[:r], jtau[:r])
    else:
        np.testing.assert_array_equal(jp, jjp)
        _agree(_t(Ap), jAp)
        _agree(tau.numpy(), jtau)
    # tests/lapack/test_qr.py::_check_cpqr
    kend = min(m, n)
    R = np.triu(_t(Ap)[:kend, :])
    if name == "rank4":
        assert abs(R[4, 4]) < 1e-10 * abs(R[0, 0])
        return
    Im = et.from_global(np.eye(m, dtype=F.dtype), et.MC, et.MR, grid=A.grid)
    Q = _t(et.apply_q(Ap, tau, Im, orient="N"))
    perm = np.concatenate([jp, np.setdiff1d(np.arange(n), jp)]) \
        if n > kend else jp
    assert np.linalg.norm(Q[:, :kend] @ R - F[:, perm]) \
        / np.linalg.norm(F) < 1e-13
    rd = np.abs(np.diag(R))
    assert np.all(rd[:-1] >= rd[1:] - 1e-10)      # greedy pivot order
    if name == "records":
        assert getattr(Ap, "_qr_nb") == nb
        with pytest.raises(ValueError, match="block size"):
            et.apply_q(Ap, tau, _tg(np.ones((16, 2)), rc), nb=12)


def _lufp_input(name):
    """tests/lapack/test_variants.py::test_lu_full_pivot and
    ::test_lu_full_pivot_growth_matrix, and a wide and a tall case."""
    if name == "random":
        return np.random.default_rng(6).normal(size=(29, 29))
    if name == "growth":
        n = 16
        F = np.eye(n) - np.tril(np.ones((n, n)), -1)
        F[:, -1] = 1.0
        return F
    if name == "wide":
        return np.random.default_rng(7).normal(size=(12, 20))
    return np.random.default_rng(8).normal(size=(20, 12))


@functools.lru_cache(maxsize=None)
def _jax_lufp(name):
    LU, rp, cp = j_lu_full_pivot(_jg(_lufp_input(name)))
    return np.asarray(el.to_global(LU)), np.asarray(rp), np.asarray(cp)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("name", ["random", "growth", "wide", "tall"])
def test_lu_full_pivot_matches_jax(rc, name):
    F = _lufp_input(name)
    m, n = F.shape
    LU, rp, cp = et.lu_full_pivot(_tg(F, rc))
    lug, rpn, cpn = _t(LU), rp.numpy(), cp.numpy()
    jLU, jrp, jcp = _jax_lufp(name)
    np.testing.assert_array_equal(rpn, jrp)
    np.testing.assert_array_equal(cpn, jcp)
    _agree(lug, jLU)
    k = min(m, n)
    L = np.tril(lug, -1)[:, :k] + np.eye(m, k)
    U = np.triu(lug)[:k]
    assert np.allclose(L @ U, F[np.ix_(rpn, cpn)], atol=1e-9)
    # complete pivoting bounds |L| by 1, and keeps the growth matrix's U
    # small (partial pivoting gives 2^(n-1))
    assert np.abs(L).max() <= 1 + 1e-12
    if name == "growth":
        assert np.abs(U).max() < 8
