"""QR and least squares on the device grid: ``qr`` (classic panel),
``apply_q`` and ``least_squares`` with every rank's block on its own
device (here ``Grid(r, c, devices=["cpu"] * (r * c))``; the panels run
their plain versions on the CPU).

Held against the JAX package (``el.Grid(jax.devices()[:r * c],
height=r)``) and the port's virtual grid of the same shape on 1x1, 2x2,
2x3 and 1x3 grids, tall, wide and tall-skinny, float64 and complex128:
the packed factor and ``tau``, ``apply_q`` in both orients and
``least_squares`` within 1e-12 relative, with the virtual grid's
redistribution counts and records and its recorded block size, ``A``
and ``B`` left as they were and no tile shared between ranks."""
import importlib

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu_torch.core import ranks
from elemental_tpu_torch.redist import engine
from .torch_shared_ref import shared_cache
from .test_torch_device_grid import (GRIDS, GRID_IDS, _close, _matrix,
                                     _records, dgrid, jgrid, vgrid)

SHAPES = [(37, 29), (29, 37), (37, 11)]
SHAPE_IDS = ["tall", "wide", "skinny"]
NB, NRHS = 8, 5


def _rhs(m, dtype):
    return _matrix((m, NRHS), seed=31, dtype=dtype)


def _ref_grid(rc, shape):
    """The mesh of a case's JAX reference: the port's own grid for the
    tall shape, 2x3 for the others (the replicated classic panel reduces
    the same columns on every grid, so the factor differs by rounding
    only), so that fewer JAX programs compile."""
    return rc if shape == SHAPES[0] else (2, 3)


@shared_cache
def _jax_qr(rc, shape, dtype_name):
    """The JAX package's packed factor, tau, Q B, Q^H B and (tall) least
    squares solution on the ``rc`` mesh, under one ``jax.jit``."""
    dtype = np.dtype(dtype_name).type
    jg = jgrid(*rc)
    jA = el.from_global(_matrix(shape, seed=30, dtype=dtype), el.MC, el.MR,
                        jg)
    jB = el.from_global(_rhs(shape[0], dtype), el.MC, el.MR, jg)

    def f(a, b):
        # least_squares(a, b) is these steps: qr, Q^H b, the triangular
        # solve against the interior R (one factorization to compile)
        Ap, tau = el.qr(a, nb=NB)
        QhB = el.apply_q(Ap, tau, b, orient="C")
        X = None
        if shape[0] >= shape[1]:
            n = shape[1]
            R = el.make_trapezoidal(el.interior_view(Ap, (0, n), (0, n)),
                                    "U")
            X = el.trsm("L", "U", "N", R,
                        el.interior_view(QhB, (0, n), (0, NRHS)), nb=NB)
        return Ap, tau, el.apply_q(Ap, tau, b, orient="N"), QhB, X
    outs = jax.jit(f)(jA, jB)
    return tuple(None if o is None else np.asarray(
        el.to_global(o) if isinstance(o, el.DistMatrix) else o) for o in outs)


def _run(grid, F, Bn):
    A = et.from_global(F, et.MC, et.MR, grid)
    B = et.from_global(Bn, et.MC, et.MR, grid)
    before = [x.clone() for x in ranks.tensors(A, B)]
    with engine.redist_counts() as counts, engine.redist_trace() as log:
        Ap, tau = et.qr(A, nb=NB)
        QB = et.apply_q(Ap, tau, B, orient="N")
        QhB = et.apply_q(Ap, tau, B, orient="C")
        X = et.least_squares(A, B, nb=NB) if F.shape[0] >= F.shape[1] \
            else None
    assert all(torch.equal(x, b)
               for x, b in zip(ranks.tensors(A, B), before))
    return (Ap, tau, QB, QhB, X), dict(counts), _records(log)


def _check(rc, F, Bn, jref):
    tg = dgrid(*rc)
    outs, counts, log = _run(tg, F, Bn)
    vouts, vcounts, vlog = _run(vgrid(*rc), F, Bn)
    Ap, tau = outs[:2]
    assert Ap._qr_nb == vouts[0]._qr_nb
    assert isinstance(tau, torch.Tensor) and tau.device == tg.devices[0]
    for got, want, ref in zip(outs, vouts, jref):
        if got is None:
            assert want is None and ref is None
            continue
        if isinstance(got, torch.Tensor):                 # tau
            _close(got.numpy(), want.numpy())
            _close(got.numpy(), ref)
            continue
        assert isinstance(got.local, ranks.Tiles)
        ptrs = [t.data_ptr() for t in got.local]
        assert len(set(ptrs)) == len(ptrs)
        _close(et.storage_numpy(got), et.storage_numpy(want))
        _close(et.to_global(got).numpy(), ref)
    assert counts == vcounts
    assert log == vlog


@pytest.mark.parametrize("rc", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_qr_apply_q_and_least_squares_match_jax(rc, shape):
    F, Bn = _matrix(shape, seed=30), _rhs(shape[0], np.float64)
    _check(rc, F, Bn, _jax_qr(_ref_grid(rc, shape), shape, "float64"))


@pytest.mark.parametrize("rc", [(2, 2), (2, 3)], ids=["2x2", "2x3"])
@pytest.mark.parametrize("shape", SHAPES[:1], ids=SHAPE_IDS[:1])
def test_complex_qr_matches_jax(rc, shape):
    F = _matrix(shape, seed=30, dtype=np.complex128)
    Bn = _rhs(shape[0], np.complex128)
    _check(rc, F, Bn, _jax_qr((2, 2), shape, "complex128"))


@pytest.mark.parametrize("rc", [(1, 1), (2, 3)], ids=["1x1", "2x3"])
def test_least_squares_solves_the_normal_equations(rc):
    F, Bn = _matrix((37, 11), seed=32), _rhs(37, np.float64)
    tg = dgrid(*rc)
    X = et.to_global(et.least_squares(et.from_global(F, et.MC, et.MR, tg),
                                      et.from_global(Bn, et.MC, et.MR, tg),
                                      nb=NB)).numpy()
    want = np.linalg.lstsq(F, Bn, rcond=None)[0]
    _close(X, want, rtol=1e-11)
    assert np.linalg.norm(F.T @ (Bn - F @ X)) < 1e-12 * np.linalg.norm(F) \
        * (np.linalg.norm(F) * np.linalg.norm(X) + np.linalg.norm(Bn))


@pytest.mark.parametrize("rc", [(2, 2), (2, 3)], ids=["2x2", "2x3"])
def test_qr_contraction_is_a_psum_over_mc(rc):
    """``V^H A2`` of the compact-WY update: every rank's local product
    summed over 'mc', within 1e-12 of the virtual grid's one product of
    the stacked storage, moving p (r - 1) x (nbw x local width x
    itemsize) bytes between ranks."""
    tqr = importlib.import_module("elemental_tpu_torch.lapack.qr")
    r, c = rc
    V, X = _matrix((37, 8), seed=33), _matrix((37, 29), seed=34)
    got, want = [], []
    for g, out in ((dgrid(r, c), got), (vgrid(r, c), want)):
        Vm = et.from_global(V, et.MC, et.STAR, g)
        Xm = et.from_global(X, et.MC, et.MR, g)
        with ranks.tally() as moved:
            W = tqr._contract_mc(Vm, Xm)
        Wm = et.DistMatrix(W, (8, 29), et.STAR, et.MR, 0, 0, g)
        out.append((et.storage_numpy(Wm), et.to_global(Wm).numpy()))
        out.append(moved.bytes)
    _close(got[0][0], want[0][0])
    _close(got[0][1], V.T @ X)
    assert got[1] == r * c * (r - 1) * 8 * (-(-29 // c)) * 8


def test_qr_refusals_on_a_device_grid():
    tg = dgrid(2, 2)
    A = et.from_global(_matrix((16, 8), seed=34), et.MC, et.MR, tg)
    for kw in (dict(panel="tsqr"), dict(health=True), dict(abft=True),
               dict(nb="auto")):
        with pytest.raises(ranks.DeviceGridError):
            et.qr(A, **kw)
    with pytest.raises(ranks.DeviceGridError):
        et.tsqr(et.from_global(_matrix((16, 4), seed=35), et.VC, et.STAR, tg))
    with pytest.raises(ranks.DeviceGridError):
        et.least_squares(A, A, abft=True)
