"""The port's ``qr`` / ``apply_q`` / ``explicit_q`` / ``least_squares`` /
``lq`` / ``explicit_l`` / ``rq`` against ``elemental_tpu`` on 1x1, 2x2 and
2x4 grids: the same numpy inputs from a seed go through both packages.
At float64 the packed factors, tau and the solutions agree to 1e-12 of
their largest entry (the same schedule; the sums round in different
libraries); complex128 runs the plain panel on both sides."""
import importlib

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.matrices.basic import identity as jax_identity

#: the JAX package's QR module (its name in ``elemental_tpu.lapack`` is
#: rebound to the function ``qr``)
jqr = importlib.import_module("elemental_tpu.lapack.qr")

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]
NB = 8
#: tall, square and wide shapes, each with a ragged last panel; the
#: other tests reuse them so that the JAX side compiles fewer programs
SHAPES = [(30, 20), (24, 24), (20, 30)]
TALL, WIDE = SHAPES[0], SHAPES[2]


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _mat(shape, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=shape)
    if np.issubdtype(dtype, np.complexfloating):
        F = F + 1j * rng.normal(size=shape)
    return F.astype(dtype)


def _both(F, rc):
    return (el.from_global(F, el.MC, el.MR, jgrid(*rc)),
            et.from_global(F, et.MC, et.MR, tgrid(*rc)))


def _close(got, want, tol=1e-12):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _glob(A):
    return et.to_global(A).numpy()


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=["tall", "square", "wide"])
def test_qr_matches_jax(rc, shape):
    F = _mat(shape, seed=1)
    jA, tA = _both(F, rc)
    before = tA.local.clone()
    jAp, jtau = jqr.qr(jA, nb=NB)
    tAp, ttau = et.qr(tA, nb=NB)
    assert torch.equal(tA.local, before)           # the input is untouched
    _close(_glob(tAp), np.asarray(el.to_global(jAp)))
    _close(ttau.numpy(), np.asarray(jtau))
    assert tAp._qr_nb == jAp._qr_nb


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_apply_q_round_trip_and_explicit_q(rc):
    m, n = 24, 16
    F, B = _mat((m, n), seed=2, dtype=np.complex128), \
        _mat((m, 5), seed=3, dtype=np.complex128)
    g = tgrid(*rc)
    Ap, tau = et.qr(et.from_global(F, et.MC, et.MR, g), nb=NB)
    Bd = et.from_global(B, et.MC, et.MR, g)
    b0 = Bd.local.clone()
    out = et.apply_q(Ap, tau, et.apply_q(Ap, tau, Bd, orient="C"),
                     orient="N")
    assert torch.equal(Bd.local, b0)
    np.testing.assert_allclose(_glob(out), B, rtol=0, atol=1e-12)
    Q = _glob(et.explicit_q(Ap, tau))
    assert np.linalg.norm(Q.conj().T @ Q - np.eye(m)) < 1e-12 * m
    R = np.triu(_glob(Ap))[:n]
    assert np.linalg.norm(F - Q[:, :n] @ R) / np.linalg.norm(F) < 1e-13


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_apply_q_matches_jax(rc):
    F, B = _mat(TALL, seed=4), _mat((TALL[0], 3), seed=5)
    jA, tA = _both(F, rc)
    jB, tB = _both(B, rc)
    jAp, jtau = jqr.qr(jA, nb=NB)
    tAp, ttau = et.qr(tA, nb=NB)
    for orient in ("N", "C"):
        jY = jqr.apply_q(jAp, jtau, jB, orient=orient)
        tY = et.apply_q(tAp, ttau, tB, orient=orient)
        _close(_glob(tY), np.asarray(el.to_global(jY)))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_least_squares_matches_jax_and_numpy(rc):
    """The whole slice: QR + Q^H B + the triangular solve."""
    F, B = _mat(TALL, seed=6), _mat((TALL[0], 3), seed=7)
    jA, tA = _both(F, rc)
    jB, tB = _both(B, rc)
    a0, b0 = tA.local.clone(), tB.local.clone()
    jX = jqr.least_squares(jA, jB, nb=NB)
    tX = et.least_squares(tA, tB, nb=NB)
    assert torch.equal(tA.local, a0) and torch.equal(tB.local, b0)
    got = _glob(tX)
    _close(got, np.asarray(el.to_global(jX)))
    _close(got, np.linalg.lstsq(F, B, rcond=None)[0], 1e-11)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_least_squares_complex(rc):
    F = _mat(TALL, seed=8, dtype=np.complex128)
    B = _mat((TALL[0], 2), seed=9, dtype=np.complex128)
    jA, tA = _both(F, rc)
    jB, tB = _both(B, rc)
    got = _glob(et.least_squares(tA, tB, nb=NB))
    _close(got, np.asarray(el.to_global(jqr.least_squares(jA, jB, nb=NB))))
    _close(got, np.linalg.lstsq(F, B, rcond=None)[0], 1e-11)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_lq_and_explicit_l_match_jax(rc):
    F = _mat(WIDE, seed=10)
    m, n = WIDE
    jA, tA = _both(F, rc)
    jP, jtau = jqr.lq(jA, nb=NB)
    tP, ttau = et.lq(tA, nb=NB)
    _close(_glob(tP), np.asarray(el.to_global(jP)))
    _close(ttau.numpy(), np.asarray(jtau))
    L = _glob(et.explicit_l(tP))
    _close(L, np.asarray(el.to_global(jqr.explicit_l(jP))))
    # A = L Q with Q the first rows of the LQ unitary
    Q = _glob(et.apply_q_lq(tP, ttau, et.identity(n, grid=tgrid(*rc),
                                                  dtype=torch.float64)))
    assert np.linalg.norm(F - L @ Q[:m]) / np.linalg.norm(F) < 1e-13


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("shape", [WIDE, TALL], ids=["wide", "tall"])
def test_rq_matches_jax(rc, shape):
    F = _mat(shape, seed=11)
    jA, tA = _both(F, rc)
    jR, jQ = jqr.rq(jA, nb=NB)
    tR, tQ = et.rq(tA, nb=NB)
    R, Q = _glob(tR), _glob(tQ)
    _close(R, np.asarray(el.to_global(jR)))
    _close(Q, np.asarray(el.to_global(jQ)))
    assert np.linalg.norm(F - R @ Q) / np.linalg.norm(F) < 1e-13


@pytest.mark.parametrize("rc", [(1, 1), (2, 4)], ids=["1x1", "2x4"])
def test_identity_storage_bit_equal(rc):
    for m, n in ((9, 9), (7, 11)):
        jI = jax_identity(m, n, grid=jgrid(*rc), dtype=jax.numpy.float64)
        tI = et.identity(m, n, grid=tgrid(*rc), dtype=torch.float64)
        assert np.array_equal(et.storage_numpy(tI), np.asarray(jI.local))


def test_qr_nb_record_and_mismatch():
    g = tgrid(2, 2)
    A = et.from_global(_mat((20, 12), seed=12), et.MC, et.MR, g)
    B = et.from_global(_mat((20, 2), seed=13), et.MC, et.MR, g)
    Ap, tau = et.qr(A, nb=4)
    assert Ap._qr_nb == 4
    same = et.apply_q(Ap, tau, B, orient="C", nb=4)
    default = et.apply_q(Ap, tau, B, orient="C")
    assert torch.equal(same.local, default.local)
    with pytest.raises(ValueError, match="block size 4"):
        et.apply_q(Ap, tau, B, orient="C", nb=8)
    with pytest.raises(ValueError, match="m >= n"):
        et.least_squares(et.from_global(_mat((8, 12)), et.MC, et.MR, g),
                         et.from_global(_mat((8, 1)), et.MC, et.MR, g))


def test_panel_impl_torch_matches_default_on_cpu():
    A = et.from_global(_mat((40, 24), seed=14), et.MC, et.MR, tgrid(1, 1))
    Pa, ta = et.qr(A, nb=16)
    Pb, tb = et.qr(A, nb=16, panel_impl="torch")
    Pc, tc = et.qr(A, nb=16, panel_impl="kernel")   # the plain version here
    assert torch.equal(Pa.local, Pb.local) and torch.equal(ta, tb)
    _close(Pc.local.numpy(), Pa.local.numpy())
    _close(tc.numpy(), ta.numpy())


@pytest.fixture
def empty_tune_cache(tmp_path, monkeypatch):
    """Both packages' tuners on an empty cache (the cost model decides)."""
    from elemental_tpu.tune import cache as jc, policy as jp
    from elemental_tpu_torch.tune import cache as tc, policy as tp
    monkeypatch.setenv(jc.ENV_DIR, str(tmp_path / "jax"))
    monkeypatch.setenv(tc.ENV_DIR, str(tmp_path / "torch"))
    jp.clear_memo()
    tp.clear_memo()
    yield
    jp.clear_memo()
    tp.clear_memo()


_QR_KNOBS = {"nb": None, "panel": "classic", "panel_impl": None,
             "comm_precision": None, "redist_path": None}


@pytest.mark.parametrize("kw", [
    dict(nb="auto"), dict(panel="tsqr", redist_path="auto"),
    dict(panel="auto"), dict(comm_precision="auto"), dict(redist_path="auto"),
    dict(timer=object()), dict(health=True, timer=object()),
    dict(abft=True, timer=object()),
    dict(precision="bf16")], ids=lambda kw: f"{next(iter(kw))}")
def test_later_slice_knobs_raise(kw, empty_tune_cache):
    """``timer`` raises.  Each ``'auto'`` knob resolves through the tuner,
    as in the JAX package, to the JAX package's value, and the call equals
    the explicit call with the resolved value (the recorded block size
    too).  ``health`` and ``abft`` are ported: beside ``timer`` the call
    still raises (the guarded driver would otherwise take it as its hook),
    and alone each knob reaches its monitor or its guarded driver, which
    files a fresh report."""
    A = et.from_global(_mat((8, 8)), et.MC, et.MR, tgrid(1, 1))
    knob = next(iter(kw))
    autos = [k for k, v in kw.items() if v == "auto"]
    if autos:
        knobs = {**_QR_KNOBS, **kw}
        kn = et.tune.resolve_knobs("qr", gshape=A.gshape, dtype=A.dtype,
                                   grid=A.grid, knobs=knobs)
        jn = el.tune.resolve_knobs("qr", gshape=A.gshape, dtype=np.float64,
                                   grid=jgrid(1, 1), knobs=knobs)
        assert all(kn[k] == jn[k] and kn[k] != "auto" for k in autos)
        Pa, ta = et.qr(A, **kw)
        Pe, te = et.qr(A, **{k: kn[k] for k in kw})
        assert torch.equal(Pa.local, Pe.local) and torch.equal(ta, te)
        assert Pa._qr_nb == Pe._qr_nb
        return
    with pytest.raises(NotImplementedError, match="later slice"):
        et.qr(A, **kw)
    if knob in ("health", "abft"):
        last = {"health": et.resilience.last_health_report,
                "abft": et.resilience.last_abft_report}[knob]
        before = last("qr")
        et.qr(A, **{knob: True})
        rep = last("qr")
        assert rep is not before and rep["driver"] == "qr" and rep["ok"]


def test_other_later_slice_knobs_and_bad_panel(empty_tune_cache):
    """``least_squares(nb='auto', abft=True)`` and ``lq(redist_path=
    'auto')`` resolve as in the JAX package and agree with its 'auto'
    calls to 1e-12."""
    g = tgrid(1, 1)
    F, Fb = _mat((8, 4)), _mat((8, 1))
    A = et.from_global(F, et.MC, et.MR, g)
    B = et.from_global(Fb, et.MC, et.MR, g)
    jA = el.from_global(F, el.MC, el.MR, jgrid(1, 1))
    jB = el.from_global(Fb, el.MC, el.MR, jgrid(1, 1))
    X = et.least_squares(A, B, nb="auto", abft=True)
    _close(et.to_global(X).numpy(), np.asarray(el.to_global(
        el.least_squares(jA, jB, nb="auto", abft=True))))
    Pl, tl = et.lq(A, redist_path="auto")
    jP, jt = el.lq(jA, redist_path="auto")
    _close(et.to_global(Pl).numpy(), np.asarray(el.to_global(jP)))
    _close(tl.numpy(), np.asarray(jt))
    with pytest.raises(ValueError, match="panel strategy"):
        et.qr(A, panel="tree")
