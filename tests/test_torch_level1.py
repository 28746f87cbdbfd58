"""The port's level-1 zoo, ``pad_matrix`` and the stacking helpers against
``elemental_tpu`` on 1x1, 2x2 and 2x4 grids: the same numpy inputs from a
seed go through both packages.  Ops that only move values (trapezoids,
diagonals, parts, transposes, submatrices, pads, stacks, the location
reductions) give bit-equal storage; arithmetic ops, norms, ``trace`` and
the inner products agree to 1e-13.  Mirrors ``tests/blas/test_level1.py``.
"""
import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.blas import level1 as jl1
from elemental_tpu.core.view import pad_matrix as jpad
from elemental_tpu.redist.interior import vstack as jvstack, \
    hstack as jhstack
from elemental_tpu_torch.blas import level1 as tl1

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]
DISTS = [("MC", "MR"), ("MR", "MC"), ("VC", "STAR"), ("STAR", "VR")]
DIDS = ["mcmr", "mrmc", "vcstar", "starvr"]


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _mk(rc, m=13, n=9, cplx=False, seed=0, dist=("MC", "MR")):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(m, n))
    if cplx:
        X = X + 1j * rng.normal(size=(m, n))
    jd = tuple(getattr(el, d) for d in dist)
    td = tuple(getattr(et, d) for d in dist)
    return (X, el.from_global(X, *jd, grid=jgrid(*rc)),
            et.from_global(X, *td, grid=tgrid(*rc)))


def _same(tA, jA):
    """Bit-equal storage and the same metadata."""
    assert tA.gshape == tuple(jA.gshape)
    assert (tA.cdist.value, tA.rdist.value) == (jA.cdist.value,
                                                jA.rdist.value)
    np.testing.assert_array_equal(et.storage_numpy(tA), np.asarray(jA.local))


def _close(tA, jA, tol=1e-13):
    a, b = et.storage_numpy(tA), np.asarray(jA.local)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1))


def _scalar(t, j, tol=1e-13):
    t = complex(t.item()) if hasattr(t, "item") else complex(t)
    j = complex(np.asarray(j))
    assert abs(t - j) <= tol * max(abs(j), 1), (t, j)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("cplx", [False, True], ids=["f64", "c128"])
def test_elementwise_match_jax(rc, cplx):
    X, jX, tX = _mk(rc, cplx=cplx, seed=1)
    Y, jY, tY = _mk(rc, cplx=cplx, seed=2)
    _close(tl1.axpy(2.5, tX, tY), jl1.axpy(2.5, jX, jY))
    _close(tl1.scale(-3.0, tX), jl1.scale(-3.0, jX))
    _close(tl1.hadamard(tX, tY), jl1.hadamard(jX, jY))
    _close(tl1.entrywise_map(tX, lambda a: a * a),
           jl1.entrywise_map(jX, lambda a: a * a))
    _close(tl1.safe_scale(3.0, 2.0, tX), jl1.safe_scale(3.0, 2.0, jX))
    # value moves: bit-equal
    _same(tl1.zero(tX), jl1.zero(jX))
    _same(tl1.fill(tX, 7.0), jl1.fill(jX, 7.0))
    _same(tl1.conjugate(tX), jl1.conjugate(jX))
    _same(tl1.real_part(tX), jl1.real_part(jX))
    _same(tl1.imag_part(tX), jl1.imag_part(jX))
    _same(tl1.round_entries(tX), jl1.round_entries(jX))
    a, b = tl1.swap(tX, tY)
    ja, jb = jl1.swap(jX, jY)
    _same(a, ja)
    _same(b, jb)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("dist", DISTS, ids=DIDS)
def test_index_ops_storage_bit_equal(rc, dist):
    X, jX, tX = _mk(rc, cplx=True, seed=3, dist=dist)
    for uplo, off in (("L", 0), ("U", 0), ("L", -2), ("U", 3)):
        _same(tl1.make_trapezoidal(tX, uplo, off),
              jl1.make_trapezoidal(jX, uplo, off))
    _same(tl1.transpose(tX), jl1.transpose(jX))
    _same(tl1.adjoint(tX), jl1.adjoint(jX))
    for off in (0, 2, -3):
        _same(tl1.get_diagonal(tX, off), jl1.get_diagonal(jX, off))
    np.testing.assert_array_equal(
        et.to_global(tl1.get_diagonal(tX)).numpy().ravel(), np.diag(X))
    dv = np.arange(1.0, 10.0).reshape(9, 1)
    jd = el.from_global(dv, el.STAR, el.STAR, grid=jgrid(*rc))
    td = et.from_global(dv, et.STAR, et.STAR, grid=tgrid(*rc))
    for off in (0, 1, -4):
        _same(tl1.set_diagonal(tX, td, off), jl1.set_diagonal(jX, jd, off))
        _close(tl1.update_diagonal(tX, td, off),
               jl1.update_diagonal(jX, jd, off))
        _close(tl1.shift_diagonal(tX, 2.5, off),
               jl1.shift_diagonal(jX, 2.5, off))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_submatrix_pad_and_stack_bit_equal(rc):
    X, jX, tX = _mk(rc, m=12, n=10, seed=4)
    _same(tl1.get_submatrix(tX, 3, 2, 6, 5), jl1.get_submatrix(jX, 3, 2, 6, 5))
    B, jB, tB = _mk(rc, m=6, n=5, seed=5)
    _same(tl1.set_submatrix(tX, 3, 2, tB), jl1.set_submatrix(jX, 3, 2, jB))
    for M, N in ((12, 10), (15, 10), (17, 13)):
        _same(et.pad_matrix(tX, M, N), jpad(jX, M, N))
    with pytest.raises(ValueError, match="smaller"):
        et.pad_matrix(tX, 11, 10)
    Y, jY, tY = _mk(rc, m=7, n=10, seed=6)
    _same(et.vstack(tX, tY), jvstack(jX, jY))
    Z, jZ, tZ = _mk(rc, m=12, n=3, seed=7)
    _same(et.hstack(tX, tZ), jhstack(jX, jZ))
    with pytest.raises(ValueError, match="width"):
        et.vstack(tX, tZ)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("cplx", [False, True], ids=["f64", "c128"])
def test_norms_trace_and_dots_match_jax(rc, cplx):
    X, jX, tX = _mk(rc, m=11, n=11, cplx=cplx, seed=8)
    Y, jY, tY = _mk(rc, m=11, n=11, cplx=cplx, seed=9)
    for name in ("frobenius_norm", "max_norm", "one_norm", "infinity_norm",
                 "nrm2", "trace"):
        _scalar(getattr(tl1, name)(tX), getattr(jl1, name)(jX))
    _scalar(tl1.entrywise_norm(tX, 3), jl1.entrywise_norm(jX, 3))
    _scalar(tl1.zero_norm(tX, 0.5), jl1.zero_norm(jX, 0.5))
    _scalar(tl1.dot(tX, tY), jl1.dot(jX, jY))
    _scalar(tl1.dotu(tX, tY), jl1.dotu(jX, jY))
    _scalar(tl1.trace(tX), np.trace(X))
    _scalar(tl1.one_norm(tX), np.abs(X).sum(0).max())


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("dist", DISTS[:3], ids=DIDS[:3])
def test_loc_reductions_match_jax(rc, dist):
    X, jX, tX = _mk(rc, seed=10, dist=dist)
    for name, ref in (("max_abs_loc", np.argmax(np.abs(X))),
                      ("min_abs_loc", np.argmin(np.abs(X))),
                      ("max_loc", np.argmax(X)), ("min_loc", np.argmin(X))):
        v, (i, j) = getattr(tl1, name)(tX)
        jv, (ji, jj) = getattr(jl1, name)(jX)
        assert (int(i), int(j)) == (int(ji), int(jj)) \
            == tuple(int(x) for x in np.unravel_index(ref, X.shape))
        assert float(v) == float(jv)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("uplo,off", [("L", 0), ("U", 0), ("L", -2),
                                      ("U", 3)])
def test_trapezoid_updates_match_jax(rc, uplo, off):
    X, jX, tX = _mk(rc, m=11, n=11, seed=11)
    Y, jY, tY = _mk(rc, m=11, n=11, seed=12)
    _close(tl1.scale_trapezoid(2.0, tX, uplo, off),
           jl1.scale_trapezoid(2.0, jX, uplo, off))
    _close(tl1.axpy_trapezoid(3.0, tX, tY, uplo, off),
           jl1.axpy_trapezoid(3.0, jX, jY, uplo, off))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_diagonal_scale_solve_match_jax(rc):
    X, jX, tX = _mk(rc, m=8, n=5, seed=13)
    for side, k in (("L", 8), ("R", 5)):
        dv = np.arange(1.0, k + 1.0).reshape(k, 1)
        dv[1] = 0.0                       # diagonal_solve drops a zero
        jd = el.from_global(dv, el.STAR, el.STAR, grid=jgrid(*rc))
        td = et.from_global(dv, et.STAR, et.STAR, grid=tgrid(*rc))
        _same(tl1.diagonal_scale(side, td, tX),
              jl1.diagonal_scale(side, jd, jX))
        _close(tl1.diagonal_solve(side, td, tX),
               jl1.diagonal_solve(side, jd, jX))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_get_diagonal_md_storage_bit_equal(rc):
    X, jX, tX = _mk(rc, m=13, n=9, seed=14)
    _same(tl1.get_diagonal(tX, dist="md"), jl1.get_diagonal(jX, dist="md"))
    np.testing.assert_array_equal(
        et.to_global(tl1.get_diagonal(tX, dist="md")).numpy().ravel(),
        np.diag(X))


def test_safe_scale_stages_and_refuses_zero():
    X, jX, tX = _mk((2, 2), seed=15)
    out = tl1.safe_scale(1e-300, 1e-10, tX)      # ratio 1e-290: stages
    _close(out, jl1.safe_scale(1e-300, 1e-10, jX), tol=1e-12)
    np.testing.assert_allclose(et.to_global(out).numpy(), X * 1e-290,
                               rtol=1e-12)
    with pytest.raises(ValueError, match="nonzero"):
        tl1.safe_scale(1.0, 0.0, tX)
    with pytest.raises(ValueError, match="layout"):
        tl1.axpy(1.0, tX, _mk((2, 2), m=9, n=13)[2])
