"""The port's level-2 BLAS (``gemv``, ``ger``, ``hemv``, ``symv``, ``her2``,
``trmv``, ``trsv``) and the level-1 maps it adds (``index_dependent_map``,
``index_dependent_fill``, ``make_symmetric``) against ``elemental_tpu`` on
1x1, 2x2 and 2x4 grids: the same numpy inputs from a seed go through both
packages, and the storage agrees to 1e-12 of its largest entry
(complex128 and float64).  ``hemv`` reads one triangle only: the other is
poisoned with NaN."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]
CPLX = np.complex128


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _mat(shape, seed, dtype=CPLX):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=shape)
    if np.issubdtype(dtype, np.complexfloating):
        F = F + 1j * rng.normal(size=shape)
    return F.astype(dtype)


def _both(F, rc):
    return (el.from_global(F, el.MC, el.MR, jgrid(*rc)),
            et.from_global(F, et.MC, et.MR, tgrid(*rc)))


def _close(tA, jA, tol=1e-12):
    want = np.asarray(jA.local)
    got = et.storage_numpy(tA)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.nanmax(np.abs(want)))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("orient", ["N", "T", "C"])
def test_gemv_matches_jax(rc, orient):
    A = _mat((13, 9), 0)
    x = _mat((9 if orient == "N" else 13, 1), 1)
    y = _mat((13 if orient == "N" else 9, 1), 2)
    (jA, tA), (jx, tx), (jy, ty) = _both(A, rc), _both(x, rc), _both(y, rc)
    out = et.gemv(tA, tx, alpha=2.0, beta=-1.5, y=ty, orient=orient)
    _close(out, el.gemv(jA, jx, alpha=2.0, beta=-1.5, y=jy, orient=orient))
    _close(et.gemv(tA, tx, orient=orient), el.gemv(jA, jx, orient=orient))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("conj", [True, False])
def test_ger_matches_jax(rc, conj):
    (jA, tA), (jx, tx), (jy, ty) = (_both(_mat((11, 7), 3), rc),
                                    _both(_mat((11, 1), 4), rc),
                                    _both(_mat((7, 1), 5), rc))
    out = et.ger(0.5 + 0.25j, tx, ty, tA, conj=conj)
    _close(out, el.ger(0.5 + 0.25j, jx, jy, jA, conj=conj))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("dtype", [np.float64, CPLX], ids=["f64", "c128"])
def test_hemv_and_symv_read_one_triangle_and_match_jax(rc, uplo, dtype):
    G = _mat((10, 10), 6, dtype)
    H = (G + G.conj().T) / 2
    P = H.copy()
    P[np.triu_indices(10, 1) if uplo == "L" else np.tril_indices(10, -1)] \
        = np.nan
    (jP, tP), (jx, tx), (jy, ty) = (_both(P, rc), _both(_mat((10, 1), 7, dtype), rc),
                                    _both(_mat((10, 1), 8, dtype), rc))
    out = et.hemv(uplo, tP, tx, alpha=1.5, beta=0.5, y=ty)
    _close(out, el.hemv(uplo, jP, jx, alpha=1.5, beta=0.5, y=jy))
    x = _mat((10, 1), 7, dtype)
    y = _mat((10, 1), 8, dtype)
    np.testing.assert_allclose(et.to_global(out).numpy(), 1.5 * H @ x + 0.5 * y,
                               rtol=1e-12)
    # symv: the transpose image, not the conjugate one
    _close(et.symv(uplo, tP, tx), el.symv(uplo, jP, jx))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_her2_matches_jax(rc, uplo):
    G = _mat((9, 9), 9)
    (jH, tH), (jx, tx), (jy, ty) = (_both(G + G.conj().T, rc),
                                    _both(_mat((9, 1), 10), rc),
                                    _both(_mat((9, 1), 11), rc))
    a = 0.3 - 0.7j
    _close(et.her2(uplo, a, tx, ty, tH), el.her2(uplo, a, jx, jy, jH))
    _close(et.her2(uplo, 0.5, tx, ty, tH, conj=False),
           el.her2(uplo, 0.5, jx, jy, jH, conj=False))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("uplo,orient,unit", [("L", "N", False), ("U", "N", True),
                                              ("U", "C", False), ("L", "T", True)])
def test_trmv_trsv_match_jax(rc, uplo, orient, unit):
    T = _mat((8, 8), 12)
    T = (np.tril(T) if uplo == "L" else np.triu(T)) + 3 * np.eye(8)
    (jT, tT), (jx, tx) = _both(T, rc), _both(_mat((8, 1), 13), rc)
    ty = et.trmv(uplo, orient, tT, tx, unit=unit)
    jy = el.trmv(uplo, orient, jT, jx, unit=unit)
    _close(ty, jy)
    back = et.trsv(uplo, orient, tT, ty, unit=unit, nb=4)
    _close(back, el.trsv(uplo, orient, jT, jy, unit=unit, nb=4), tol=1e-10)
    np.testing.assert_allclose(et.to_global(back).numpy(), _mat((8, 1), 13),
                               rtol=1e-9)


def test_vector_shape_is_checked():
    g = tgrid(1, 1)
    A = et.from_global(_mat((5, 4), 0), et.MC, et.MR, g)
    x = et.from_global(_mat((5, 1), 1), et.MC, et.MR, g)
    with pytest.raises(ValueError):
        et.gemv(A, x)
    with pytest.raises(ValueError):
        et.hemv("L", A, x)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_index_dependent_map_and_fill_match_jax(rc):
    F = _mat((11, 7), 14, np.float64)
    jA, tA = _both(F, rc)
    _close(et.index_dependent_map(tA, lambda i, j, a: a * (i + 1) - j),
           el.blas.level1.index_dependent_map(jA, lambda i, j, a: a * (i + 1) - j))
    tout = et.index_dependent_fill(tA, lambda i, j: torch.where(
        i >= j, (10.0 * i + j).double(), 0.0))
    jout = el.blas.level1.index_dependent_fill(jA, lambda i, j: jnp.where(
        i >= j, 10.0 * i + j, 0.0))
    _close(tout, jout)
    # padding stays zero
    want = np.where(np.arange(11)[:, None] >= np.arange(7)[None, :],
                    10.0 * np.arange(11)[:, None] + np.arange(7)[None, :], 0.0)
    np.testing.assert_array_equal(et.to_global(tout).numpy(), want)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("conj", [True, False])
def test_make_symmetric_matches_jax(rc, uplo, conj):
    jA, tA = _both(_mat((9, 9), 15), rc)
    _close(et.make_symmetric(tA, uplo, conj=conj),
           el.blas.level1.make_symmetric(jA, uplo, conj=conj))
