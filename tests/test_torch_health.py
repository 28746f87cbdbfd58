"""Numerical-health guards in the port (mirroring
``tests/resilience/test_health.py``), held against the JAX package.

``health_report/v1`` equals the JAX package's field by field for lu,
cholesky and qr on 1x1 and 2x2 grids, clean and with a NaN / singular
input (floats to 1e-12 relative in float64; each JAX reference is
computed once per module).  The JAX test's own assertions then run on
the port alone.  A tick keeps device scalars and syncs nothing; the
report brings them over at once."""
import functools

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu import resilience as jres
from elemental_tpu_torch.obs import metrics_scope
from elemental_tpu_torch.redist import engine as t_engine
from elemental_tpu_torch.resilience import (HEALTH_SCHEMA, HealthMonitor,
                                            last_health_report)
from elemental_tpu_torch.resilience.health import _float_leaves, _maxabs

GRIDS = [(1, 1), (2, 2)]


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _spd(rng, n):
    F = rng.normal(size=(n, n))
    return F @ F.T / n + n * np.eye(n)


def _input(case):
    """The host matrices of the parity cases (float64)."""
    rng = np.random.default_rng(71)
    F = rng.normal(size=(24, 24))
    if case == "clean":
        return F + 24 * np.eye(24)
    if case == "spd":
        return _spd(rng, 24)
    if case == "nan":
        F[5, 7] = np.nan
        return F
    if case == "singular":
        F[9] = F[2]
        return F
    if case == "rankdef":
        F[:, 13] = F[:, 4]
        return F
    raise KeyError(case)


def _call(pkg, g, driver, M, mon, **kw):
    A = pkg.from_global(M, pkg.MC, pkg.MR, grid=g)
    getattr(pkg, driver)(A, nb=8, health=mon, **kw)
    return mon.report()


@functools.cache
def _jax_report(rc, driver, case, kw=()):
    return _call(el, jgrid(*rc), driver, _input(case),
                 jres.HealthMonitor(), **dict(kw))


_NOISE = 16 * np.finfo(np.float64).eps


def _same_report(rt, rj, rtol=1e-12, anchor=True):
    """Field by field; ``anchor=False`` leaves out ``scale`` and
    ``growth_estimate`` (see :func:`test_report_equals_jax`)."""
    assert set(rt) == set(rj)
    for key in ("schema", "driver", "ok", "checks", "failing_phase"):
        assert rt[key] == rj[key], key
    floats = ("growth_estimate", "scale", "min_diag") if anchor \
        else ("min_diag",)
    for key in floats:
        if rj[key] is None:
            assert rt[key] is None, key
        else:
            assert rt[key] == pytest.approx(rj[key], rel=rtol,
                                            nan_ok=True), key
    assert len(rt["flags"]) == len(rj["flags"])
    for ft, fj in zip(rt["flags"], rj["flags"]):
        assert {k: v for k, v in ft.items() if k != "value"} \
            == {k: v for k, v in fj.items() if k != "value"}
        if fj["value"] is None:
            assert ft["value"] is None
        elif fj["kind"] == "small_pivot" and fj["value"] < _NOISE * rj["scale"]:
            # the zero pivot of an exactly singular input is rounding
            # noise of its own elimination: a few eps of max |A|
            assert abs(ft["value"] - fj["value"]) <= _NOISE * rj["scale"]
        else:
            assert ft["value"] == pytest.approx(fj["value"], rel=rtol, abs=0)


PARITY = [((1, 1), "lu", "clean", ()), ((2, 2), "lu", "clean", ()),
          ((1, 1), "lu", "nan", ()), ((2, 2), "lu", "nan", ()),
          ((2, 2), "lu", "singular", (("crossover", 0),)),
          ((1, 1), "cholesky", "spd", ()), ((2, 2), "cholesky", "spd", ()),
          ((1, 1), "qr", "clean", ()), ((2, 2), "qr", "nan", ()),
          ((2, 2), "qr", "rankdef", ())]


@pytest.mark.parametrize("rc,driver,case,kw", PARITY,
                         ids=[f"{r}x{c}-{d}-{k}"
                              for (r, c), d, k, _ in PARITY])
def test_report_equals_jax(rc, driver, case, kw):
    """A NaN input on a 2x2 grid is the one divergence: the JAX package's
    ``max |A|`` anchor reduces across its four devices and the
    cross-device max drops the NaN (3.31 here), while the port's one
    reduction keeps it (NaN, as the JAX package gives on a 1x1 grid).
    Every flag, and so the verdict, is the same."""
    rj = _jax_report(rc, driver, case, kw)
    rt = _call(et, tgrid(*rc), driver, _input(case), HealthMonitor(),
               **dict(kw))
    sharded_nan = case == "nan" and rc != (1, 1)
    _same_report(rt, rj, anchor=not sharded_nan)
    if sharded_nan:
        assert np.isnan(rt["scale"]) and np.isfinite(rj["scale"])


@pytest.mark.parametrize("rc", [(2, 2)], ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_guarded_health_report_equals_jax(rc):
    """The monitor bound to a guarded driver sees the committed ticks
    only (buffered per attempt), as in the JAX package."""
    M = _input("clean")[:16, :16]
    rj = _call(el, jgrid(*rc), "lu", M, jres.HealthMonitor(), abft=True)
    rt = _call(et, tgrid(*rc), "lu", M, HealthMonitor(), abft=True)
    _same_report(rt, rj)


# ---------------------------------------------------------------------
# the JAX test's assertions on the port
# ---------------------------------------------------------------------

def test_clean_lu_report_ok():
    F = _input("clean")
    rep = _call(et, tgrid(2, 2), "lu", F, HealthMonitor())
    assert rep["schema"] == HEALTH_SCHEMA
    assert rep["ok"] is True and rep["flags"] == []
    assert rep["failing_phase"] is None and rep["checks"] > 0
    assert 0.5 < rep["growth_estimate"] < 100.0
    assert rep["scale"] == pytest.approx(np.max(np.abs(F)))


def test_report_schema_pin():
    rep = _call(et, tgrid(2, 2), "lu", _input("nan"), HealthMonitor())
    assert set(rep) == {"schema", "driver", "ok", "checks", "flags",
                        "growth_estimate", "scale", "min_diag",
                        "failing_phase"}


def test_cholesky_nonpd_flagged():
    rep = _call(et, tgrid(2, 2), "cholesky", -np.eye(16), HealthMonitor())
    assert rep["ok"] is False
    assert {f["kind"] for f in rep["flags"]} \
        & {"nonfinite", "nonpositive_diag"}


def test_growth_flag_on_blowup():
    rng = np.random.default_rng(76)
    rep = _call(et, tgrid(2, 2), "lu", rng.normal(size=(16, 16)),
                HealthMonitor(growth_limit=1e-3))
    assert any(f["kind"] == "growth" for f in rep["flags"])
    assert rep["growth_estimate"] > 1e-3


@pytest.mark.parametrize("panel", ["classic", "tsqr"])
def test_qr_nan_input_flags_nonfinite(panel):
    rep = _call(et, tgrid(2, 2), "qr", _input("nan"), HealthMonitor(),
                panel=panel)
    assert rep["ok"] is False
    assert any(fl["kind"] == "nonfinite" for fl in rep["flags"])
    assert rep["failing_phase"] in ("panel", "update")


def test_metrics_and_last_report():
    F = np.random.default_rng(77).normal(size=(16, 16))
    F[3, 3] = np.inf
    with metrics_scope() as reg:
        et.lu(et.from_global(F, et.MC, et.MR, tgrid(2, 2)), nb=8,
              health=True)
        assert reg.counter_value("health_checks", driver="lu") > 0
        flags = reg.counters("health_flags")
        assert flags and all(k[0] == "health_flags" for k in flags)
    rep = last_health_report("lu")
    assert rep is not None and rep["ok"] is False
    assert last_health_report() is rep


@pytest.mark.parametrize("driver", ["lu", "cholesky", "qr"])
@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_health_off_redist_counts_unchanged(rc, driver):
    rng = np.random.default_rng(79)
    arr = _spd(rng, 24) if driver == "cholesky" else \
        rng.normal(size=(24, 24)) + 24 * np.eye(24)
    fn = getattr(et, driver)
    g = tgrid(*rc)
    with t_engine.redist_counts() as off:
        fn(et.from_global(arr, et.MC, et.MR, g), nb=8)
    with t_engine.redist_counts() as on:
        fn(et.from_global(arr, et.MC, et.MR, g), nb=8, health=True)
    assert dict(off) == dict(on)


def test_monitor_reuse_resets():
    rng = np.random.default_rng(81)
    mon = HealthMonitor()
    F = rng.normal(size=(16, 16))
    F[1, 1] = np.nan
    assert _call(et, tgrid(2, 2), "lu", F, mon)["ok"] is False
    assert _call(et, tgrid(2, 2), "lu",
                 rng.normal(size=(16, 16)) + 16 * np.eye(16), mon)["ok"]


def test_qr_health_true_lands_in_last_report():
    et.qr(et.from_global(np.random.default_rng(133).normal(size=(16, 16)),
                         et.MC, et.MR, tgrid(1, 1)), nb=8, health=True)
    rep = last_health_report("qr")
    assert rep is not None and rep["driver"] == "qr"


# ---------------------------------------------------------------------
# the port's own: ticks keep device scalars; one max pass decides
# finiteness
# ---------------------------------------------------------------------

def test_ticks_keep_device_scalars():
    mon = HealthMonitor().begin("lu", torch.ones(4, 4))
    mon.tick("panel", 0, torch.eye(4), torch.arange(4))
    ck = mon._checks[0]
    assert isinstance(ck.maxabs, torch.Tensor) and ck.maxabs.dim() == 0
    assert isinstance(ck.diag_min, torch.Tensor)
    assert mon.report()["checks"] == 1


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf, None])
def test_maxabs_is_finite_exactly_when_the_leaf_is(bad):
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(5, 7)))
    if bad is not None:
        x[2, 3] = bad
    m = _maxabs(x)
    assert bool(torch.isfinite(m)) == bool(torch.isfinite(x).all())
    if bad is None:
        assert float(m) == float(x.abs().max())


def test_float_leaves_walk_tuples_and_distmatrices():
    A = et.from_global(np.ones((4, 4)), et.MC, et.MR, tgrid(1, 1))
    leaves = _float_leaves((A, (torch.zeros(2), torch.arange(3)), None, 5))
    assert len(leaves) == 2 and leaves[0] is A.local
