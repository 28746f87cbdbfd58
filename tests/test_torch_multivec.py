"""The port's ``DistMultiVec`` (contiguous row blocks) and the batched
remote updates of ``DistMultiVec`` and ``DistMatrix``, held against the
JAX package (the mv cases of ``tests/sparse/test_sparse.py`` and the
``remote_updates`` cases of ``tests/core/test_distmatrix.py``).

The padded storage is bit-equal to the JAX package's; the reductions
agree to 1e-13 (the summation order differs); the scatter-adds with
duplicate indices agree with a float64 reference to 1e-12 (the port's
``index_put_(accumulate=True)`` sums a duplicate in the device's order).
Each JAX reference is computed once per module."""
import functools

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.core import multivec as jmv
from elemental_tpu_torch.core import multivec as tmv

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def _xy(m=13, w=3, cplx=False):
    rng = np.random.default_rng(5)
    X, Y = rng.normal(size=(m, w)), rng.normal(size=(m, w))
    if cplx:
        X = X + 1j * rng.normal(size=(m, w))
        Y = Y + 1j * rng.normal(size=(m, w))
    return X, Y


@functools.cache
def _jax_mv(rc, cplx):
    X, Y = _xy(cplx=cplx)
    g = jgrid(*rc)
    Xd, Yd = el.mv_from_global(X, grid=g), el.mv_from_global(Y, grid=g)
    return (np.asarray(Xd.local), complex(el.mv_dot(Xd, Yd)),
            float(el.mv_nrm2(Xd)),
            np.asarray(el.mv_to_global(el.mv_axpy(2.0, Xd, Yd))))


@pytest.mark.parametrize("cplx", [False, True], ids=["f64", "c128"])
@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_multivec_equals_jax(rc, cplx):
    X, Y = _xy(cplx=cplx)
    g = tgrid(*rc)
    Xd, Yd = et.mv_from_global(X, grid=g), et.mv_from_global(Y, grid=g)
    jloc, jdot, jnrm, jaxpy = _jax_mv(rc, cplx)
    np.testing.assert_array_equal(Xd.local.numpy(), jloc)
    assert Xd.block == -(-13 // (rc[0] * rc[1])) and Xd.width == 3
    assert Xd.row_owner(12) == 12 // Xd.block
    np.testing.assert_array_equal(et.mv_to_global(Xd).numpy(), X)
    np.testing.assert_allclose(complex(et.mv_dot(Xd, Yd)), jdot, rtol=1e-13)
    np.testing.assert_allclose(float(et.mv_nrm2(Xd)), jnrm, rtol=1e-13)
    np.testing.assert_array_equal(
        et.mv_to_global(et.mv_axpy(2.0, Xd, Yd)).numpy(), jaxpy)
    np.testing.assert_array_equal(
        et.mv_to_global(et.mv_scale(-0.5, Xd)).numpy(), -0.5 * X)
    with pytest.raises(ValueError):
        et.mv_axpy(1.0, Xd, et.mv_zeros(12, 3, grid=g, dtype=Xd.dtype))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_multivec_bridges_and_vectors(rc):
    g = tgrid(*rc)
    v = et.mv_from_global(np.arange(7.0), grid=g)        # 1-D -> (m, 1)
    assert v.gshape == (7, 1)
    Z = et.mv_zeros(9, 2, grid=g, dtype=torch.float64)
    assert Z.local.shape == (rc[0] * rc[1] * Z.block, 2) and "9, 2" in repr(Z)
    X, _ = _xy()
    A = et.mv_to_distmatrix(et.mv_from_global(X, grid=g))
    assert (A.cdist, A.rdist) == (et.MC, et.MR)
    np.testing.assert_array_equal(et.to_global(A).numpy(), X)
    back = et.mv_from_distmatrix(A)
    np.testing.assert_array_equal(et.mv_to_global(back).numpy(), X)
    h = et.mv_from_global(X, grid=g, device_put=False)
    assert h.local.device.type == "cpu"


def _updates(m, n, k=200, seed=3):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, size=k)
    cols = rng.integers(0, n, size=k)
    rows[:20], cols[:20] = rows[0], cols[0]             # duplicates
    return rows, cols, rng.normal(size=k)


def _dense_ref(base, rows, cols, vals):
    ref = np.array(base, dtype=np.float64)
    np.add.at(ref, (rows, cols), vals)
    return ref


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_mv_remote_updates(rc):
    g = tgrid(*rc)
    v = et.mv_zeros(10, 2, grid=g, dtype=torch.float64)
    v = tmv.mv_remote_updates(v, [3, 3, 9], [0, 0, 1], [1.0, 2.0, 5.0])
    out = et.mv_to_global(v).numpy()
    assert out[3, 0] == 3.0 and out[9, 1] == 5.0 and out.sum() == 8.0
    with pytest.raises(ValueError):
        tmv.mv_remote_updates(v, [12], [0], [5.0])
    with pytest.raises(ValueError):
        tmv.mv_remote_updates(v, [0], [-1], [5.0])
    # many updates with duplicates, as tensors, against float64 numpy
    rows, cols, vals = _updates(10, 2)
    w = tmv.mv_remote_updates(et.mv_zeros(10, 2, grid=g, dtype=torch.float64),
                              torch.as_tensor(rows), torch.as_tensor(cols),
                              torch.as_tensor(vals))
    np.testing.assert_allclose(et.mv_to_global(w).numpy(),
                               _dense_ref(np.zeros((10, 2)), rows, cols, vals),
                               rtol=0, atol=1e-12)
    # padding rows stay zero
    assert not w.local[10:].any()


@functools.cache
def _jax_remote(rc, shape):
    F = np.arange(float(shape[0] * shape[1])).reshape(shape)
    rows, cols, vals = _updates(*shape)
    A = el.from_global(F, el.MC, el.MR, grid=jgrid(*rc))
    from elemental_tpu.core.distmatrix import remote_updates
    return np.asarray(el.to_global(remote_updates(A, rows, cols, vals)))


@pytest.mark.parametrize("shape", [(9, 7), (16, 16)])
@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_distmatrix_remote_updates_equal_jax(rc, shape):
    F = np.arange(float(shape[0] * shape[1])).reshape(shape)
    rows, cols, vals = _updates(*shape)
    A = et.from_global(F, et.MC, et.MR, grid=tgrid(*rc))
    B = et.remote_updates(A, rows, cols, vals)
    got = et.to_global(B).numpy()
    np.testing.assert_allclose(got, _dense_ref(F, rows, cols, vals),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, _jax_remote(rc, shape), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(et.to_global(A).numpy(), F)   # untouched
    assert np.count_nonzero(B.local.numpy()) <= shape[0] * shape[1]
    with pytest.raises(ValueError):
        et.remote_updates(A, [shape[0]], [0], [1.0])
    with pytest.raises(ValueError):
        et.remote_updates(et.redistribute(A, et.MD, et.STAR), [0], [0], [1.0])
