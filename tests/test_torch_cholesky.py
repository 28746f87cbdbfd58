"""The port's ``cholesky`` / ``hpd_solve`` against ``elemental_tpu`` on 1x1,
2x2 and 2x4 grids: the same numpy inputs from a seed go through both
packages.  Factors agree to rtol 1e-12 (float64, complex128) or 1e-5
(float32) -- the schedules are the same, the diagonal-block solvers round
differently; the look-ahead and classic orders agree to 1e-12, as in
``tests/lapack/test_cholesky.py``."""

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu import obs as jobs
from elemental_tpu_torch import obs as tobs
from .torch_shared_ref import shared_cache

GRIDS = [(1, 1), (2, 2), (2, 4)]
RTOL = {np.float32: 1e-5, np.float64: 1e-12, np.complex128: 1e-12}


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _step_timer(pkg_obs):
    """A PhaseTimer of package ``pkg_obs`` on a step clock (every read
    advances by one), so two packages' documents compare equal."""
    clock = iter(range(1, 10 ** 6)).__next__
    return pkg_obs.PhaseTimer(tracer=pkg_obs.Tracer(metrics=False,
                                                    clock=lambda: float(clock())))


def _hpd(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, n))
    if np.issubdtype(dtype, np.complexfloating):
        G = G + 1j * rng.normal(size=(n, n))
    return (G @ G.conj().T / n + n * np.eye(n)).astype(dtype)


@shared_cache
def _jax_chol(n, dtype, seed, *args, **kw):
    """The JAX package's global factor of ``_hpd(n, dtype, seed)`` on a
    1x1 grid, once per module: on other grids it is the same to
    rounding, and each grid compiles its own programs."""
    jA = el.from_global(_hpd(n, dtype, seed), el.MC, el.MR, jgrid(1, 1))
    return np.asarray(el.to_global(el.cholesky(jA, *args, **kw)))


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128],
                         ids=lambda d: np.dtype(d).name)
def test_cholesky_matches_jax(rc, dtype):
    F = _hpd(28, dtype, seed=1)
    tA = et.from_global(F, et.MC, et.MR, tgrid(*rc))
    before = tA.local.clone()
    jL = _jax_chol(28, dtype, 1, nb=8)
    tL = et.to_global(et.cholesky(tA, nb=8)).numpy()
    assert torch.equal(tA.local, before)          # the input is untouched
    _close(tL, jL, RTOL[dtype])
    assert np.allclose(np.triu(tL, 1), 0)


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_cholesky_upper_matches_jax(rc):
    F = _hpd(20, np.complex128, seed=2)
    tA = et.from_global(F, et.MC, et.MR, tgrid(*rc))
    jU = _jax_chol(20, np.complex128, 2, "U", nb=8)
    tU = et.to_global(et.cholesky(tA, "U", nb=8)).numpy()
    _close(tU, jU, 1e-12)
    assert np.linalg.norm(tU.conj().T @ tU - F) < 1e-13 * np.linalg.norm(F)


@pytest.mark.parametrize("lookahead,crossover",
                         [(True, 0), (True, 16), (False, 0), (False, 16)])
def test_cholesky_schedules_match_jax(lookahead, crossover):
    F = _hpd(40, np.float64, seed=3)
    tA = et.from_global(F, et.MC, et.MR, tgrid(2, 4))
    kw = dict(nb=8, lookahead=lookahead, crossover=crossover)
    jL = _jax_chol(40, np.float64, 3, nb=8)
    tL = et.to_global(et.cholesky(tA, **kw)).numpy()
    _close(tL, jL, 1e-12)


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_lookahead_matches_classic(rc):
    F = _hpd(37, np.float64, seed=4)
    A = et.from_global(F, et.MC, et.MR, tgrid(*rc))
    La = et.cholesky(A, nb=8, lookahead=True, crossover=0)
    Lb = et.cholesky(A, nb=8, lookahead=False)
    np.testing.assert_allclose(et.to_global(La).numpy(),
                               et.to_global(Lb).numpy(),
                               rtol=1e-12, atol=1e-13)


def test_cholesky_reads_only_lower_triangle():
    F = _hpd(16, np.float64, seed=5)
    junk = F + np.triu(np.random.default_rng(6).normal(size=F.shape), 1)
    for rc in ((1, 1), (2, 2)):
        L = et.cholesky(et.from_global(junk, et.MC, et.MR, tgrid(*rc)), nb=8)
        np.testing.assert_allclose(et.to_global(L).numpy(),
                                   np.linalg.cholesky(F), rtol=1e-10)


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


_CHOL_KNOBS = {"nb": None, "lookahead": True, "crossover": None,
               "panel_impl": None, "comm_precision": None,
               "redist_path": None}


@pytest.mark.parametrize("kw", [
    dict(nb="auto"), dict(lookahead="auto"), dict(crossover="auto"),
    dict(comm_precision="auto"), dict(redist_path="auto"),
    dict(timer=object()), dict(health=True, timer=object()),
    dict(abft=True, timer=object()),
    dict(precision="bf16")], ids=lambda kw: next(iter(kw)))
def test_later_slice_knobs_raise(kw, empty_tune_cache):
    """``timer`` (a PhaseTimer, alone or beside ``health`` / ``abft``)
    gives the JAX package's ``phase_timings/v1`` document and result.
    Each ``'auto'`` knob resolves through the tuner, as in the JAX
    package, to the JAX package's value, and the call equals
    the explicit call with the resolved value.  Alone, ``health`` and
    ``abft`` each reach their monitor or guarded driver, which files a
    fresh report."""
    A = et.from_global(_hpd(8, np.float64), et.MC, et.MR, tgrid(1, 1))
    knob = next(iter(kw))
    if kw[knob] == "auto":
        knobs = {**_CHOL_KNOBS, **kw}
        kn = et.tune.resolve_knobs("cholesky", gshape=A.gshape,
                                   dtype=A.dtype, grid=A.grid, knobs=knobs)
        jn = el.tune.resolve_knobs("cholesky", gshape=A.gshape,
                                   dtype=np.float64, grid=jgrid(1, 1),
                                   knobs=knobs)
        assert kn[knob] == jn[knob] and kn[knob] != "auto"
        got = et.cholesky(A, **kw)
        assert torch.equal(got.local,
                           et.cholesky(A, **{knob: kn[knob]}).local)
        return
    if "timer" in kw:
        # a PhaseTimer (step clock) beside health / abft: the same
        # phase_timings/v1 document as the JAX package's, and the result
        extra = {k: v for k, v in kw.items() if k != "timer"}
        t, jt = _step_timer(tobs), _step_timer(jobs)
        jA = el.from_global(_hpd(8, np.float64), el.MC, el.MR, jgrid(1, 1))
        got = et.cholesky(A, timer=t, **extra)
        want = el.cholesky(jA, timer=jt, **extra)
        np.testing.assert_allclose(et.to_global(got).numpy(),
                                   np.asarray(el.to_global(want)),
                                   rtol=0, atol=1e-12)
        assert t.report() == jt.report() and t.report()["steps"]
    if knob in ("health", "abft"):
        last = {"health": et.resilience.last_health_report,
                "abft": et.resilience.last_abft_report}[knob]
        before = last("cholesky")
        et.cholesky(A, **{knob: True})
        rep = last("cholesky")
        assert rep is not before and rep["driver"] == "cholesky" and rep["ok"]


def test_hpd_solve_info_raises(empty_tune_cache):
    """``info=True`` is ported, and ``nb='auto'`` beside it resolves as in
    the JAX package: the factor as op ``'cholesky'``, the two sweeps as op
    ``'trsm'``, each equal to the explicit call."""
    g = tgrid(1, 1)
    A = et.from_global(_hpd(8, np.float64), et.MC, et.MR, g)
    B = et.from_global(np.ones((8, 1)), et.MC, et.MR, g)
    Xa, info_a = et.hpd_solve(A, B, nb="auto", info=True)
    nb_c = et.tune.resolve_knobs("cholesky", gshape=A.gshape, dtype=A.dtype,
                                 grid=g, knobs={**_CHOL_KNOBS, "nb": "auto"})
    nb_t = et.tune.resolve_knobs("trsm", gshape=B.gshape, dtype=B.dtype,
                                 grid=g, knobs={"nb": "auto",
                                                "comm_precision": None,
                                                "redist_path": None})
    L = et.cholesky(A, nb=nb_c["nb"])
    want = et.cholesky_solve_after(L, B, nb=nb_t["nb"])
    assert torch.equal(Xa.local, want.local)
    assert info_a == {"singular": False, "diag_index": None, "finite": True}
    X, info = et.hpd_solve(A, B, info=True)
    assert info == {"singular": False, "diag_index": None, "finite": True}
