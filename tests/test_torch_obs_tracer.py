"""The port's span tracer (mirroring ``tests/obs/test_tracer.py``):
nesting and ordering, tick channels, hook dispatch with the ``op_calls``
count, collective events from the port's engine, and the PhaseTimer's
``phase_timings/v1`` document, held equal to the JAX package's on the
same tick streams.  No JAX computation runs here: the JAX side is its
host-only tracer fed the same ticks."""
import json

import numpy as np
import pytest
import torch

import elemental_tpu_torch as et
from elemental_tpu import obs as jobs
from elemental_tpu_torch import obs
from elemental_tpu_torch.obs.tracer import (NULL_HOOK, _Fanout,
                                            block_until_ready, phase_hook)


class FakeClock:
    """Deterministic monotone clock: each read advances by ``step``."""

    def __init__(self, step=1.0):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


# ---------------------------------------------------------------------
# explicit spans
# ---------------------------------------------------------------------

def test_span_nesting_and_ordering():
    tr = obs.Tracer(metrics=False, clock=FakeClock())
    with tr.span("outer", kind="run"):
        with tr.span("inner", k=1):
            pass
        with tr.span("inner2"):
            pass
    assert [s.name for s in tr.spans] == ["outer", "inner", "inner2"]
    assert [s.depth for s in tr.spans] == [0, 1, 1]
    o, i1, i2 = tr.spans
    assert o.t0 < i1.t0 < i1.t1 < i2.t0 < i2.t1 < o.t1
    assert o.attrs == {"kind": "run"} and i1.attrs == {"k": 1}
    # the constructing thread is the home thread (token 1)
    assert {s.thread for s in tr.spans} == {tr.home_thread} == {1}


def test_span_sync_on_cpu_tensors_and_distmatrix():
    tr = obs.Tracer(metrics=False)
    A = et.from_global(np.eye(4), et.MC, et.MR, et.Grid(device="cpu"))
    with tr.span("phase", sync=(torch.zeros(4), [A, {"x": A}])) as s:
        pass
    assert s.t1 is not None and s.t1 >= s.t0


def test_block_until_ready_ignores_non_tensors():
    block_until_ready((None, 3, "x", [torch.ones(2)]))


# ---------------------------------------------------------------------
# tick channels
# ---------------------------------------------------------------------

def _ticks(pkg_obs):
    tr = pkg_obs.Tracer(metrics=False, clock=FakeClock())
    ch = tr.channel("lu")
    ch.start()                      # t=1
    ch.tick("panel", 0)             # t=2: [1, 2]
    ch.tick("update", 0)            # t=3: [2, 3]
    ch.tick("panel", 1)             # t=4: [3, 4]
    return tr


def test_tick_channel_intervals():
    tr = _ticks(obs)
    recs = tr.phases
    assert [(r.driver, r.phase, r.step) for r in recs] == \
        [("lu", "panel", 0), ("lu", "update", 0), ("lu", "panel", 1)]
    assert [(r.t0, r.t1) for r in recs] == [(1.0, 2.0), (2.0, 3.0), (3.0, 4.0)]
    assert tr.driver_calls() == [(1, "lu", 1.0, 4.0, [0, 1])]
    assert tr.phase_totals() == {"lu": {"panel": 2.0, "update": 1.0}}
    jtr = _ticks(jobs)
    assert tr.driver_calls() == jtr.driver_calls()
    assert tr.phase_totals() == jtr.phase_totals()


def test_tick_without_start_charges_zero():
    tr = obs.Tracer(metrics=False, clock=FakeClock())
    ch = tr.channel("qr")
    ch.tick("panel", 0)
    assert tr.phases[0].seconds == 0.0


def test_two_channels_are_separate_driver_calls():
    tr = obs.Tracer(metrics=False, clock=FakeClock())
    a, b = tr.channel("gemm"), tr.channel("trsm")
    a.start()
    b.start()
    a.tick("panel", 0)
    b.tick("solve", 0)
    calls = tr.driver_calls()
    assert [c[1] for c in calls] == ["gemm", "trsm"]
    assert calls[0][0] != calls[1][0]


def test_tick_records_phase_histogram():
    with obs.metrics_scope() as reg:
        tr = obs.Tracer(clock=FakeClock())
        ch = tr.channel("cholesky")
        ch.start()
        ch.tick("diag", 0, torch.ones(3))
    (h,) = reg.to_doc()["histograms"]
    assert h["name"] == "phase_seconds" and h["count"] == 1
    assert h["labels"] == {"driver": "cholesky", "phase": "diag"}


# ---------------------------------------------------------------------
# phase_hook dispatch
# ---------------------------------------------------------------------

def test_phase_hook_null_when_inactive_counts_op_calls():
    with obs.metrics_scope() as reg:
        assert phase_hook("lu") is NULL_HOOK
        assert reg.counter_value("op_calls", op="lu") == 1


def test_phase_hook_returns_timer_when_inactive():
    t = obs.PhaseTimer()
    with obs.metrics_scope():
        assert phase_hook("cholesky", t) is t


def test_phase_hook_routes_to_active_tracer():
    tr = obs.Tracer(metrics=False)
    with obs.metrics_scope():
        with tr:
            hk = phase_hook("herk", alg="C")
            assert hk.attrs == {"alg": "C"}
            hk.tick("spread", 0)
    assert [(r.driver, r.phase) for r in tr.phases] == [("herk", "spread")]
    assert obs.active_tracer() is None


def test_phase_hook_fans_out_to_both():
    tr = obs.Tracer(metrics=False)
    t = obs.PhaseTimer()
    with obs.metrics_scope():
        with tr:
            hk = phase_hook("lu", t)
            assert isinstance(hk, _Fanout)
            hk.start()
            hk.tick("panel", 0)
    assert [r.phase for r in tr.phases] == ["panel"]
    assert [r["phase"] for r in t.records] == ["panel"]


def test_nested_activation_restores_previous():
    t1, t2 = obs.Tracer(metrics=False), obs.Tracer(metrics=False)
    with obs.metrics_scope():
        with t1:
            with t2:
                assert obs.active_tracer() is t2
            assert obs.active_tracer() is t1
    assert obs.active_tracer() is None


@pytest.mark.parametrize("driver,call", [
    ("gemm", lambda A: et.gemm(A, A, alg="C", nb=4)),
    ("herk", lambda A: et.herk("L", A, nb=4)),
    ("trsm", lambda A: et.trsm("L", "L", "N", A, A, nb=4)),
])
def test_gemm_herk_trsm_count_op_calls_and_tick(driver, call):
    """gemm and herk now count ``op_calls`` and tick (trsm did before)."""
    rng = np.random.default_rng(3)
    F = rng.normal(size=(12, 12)) + 12 * np.eye(12)
    A = et.from_global(F, et.MC, et.MR, et.Grid(2, 2, device="cpu"))
    tr = obs.Tracer(metrics=False)
    with obs.metrics_scope() as reg:
        with tr:
            call(A)
        assert reg.counter_value("op_calls", op=driver) == 1
    assert {r.driver for r in tr.phases} == {driver}
    want, first = {"gemm": ({"panel"}, "panel"),
                   "herk": ({"spread", "update"}, "spread"),
                   "trsm": ({"solve", "update"}, "solve")}[driver]
    assert {r.phase for r in tr.phases} == want
    assert [r.step for r in tr.phases if r.phase == first] == [0, 1, 2]


# ---------------------------------------------------------------------
# collective events
# ---------------------------------------------------------------------

def _fake_record(grid_shape=(2, 2), dtype="float32", wire=""):
    from elemental_tpu_torch.core.dist import MC, MR, STAR
    from elemental_tpu_torch.redist.engine import RedistRecord
    return RedistRecord(kind="redistribute", src=(MC, MR), dst=(STAR, STAR),
                        gshape=(64, 64), dtype=dtype, in_id=1,
                        out_ids=(2,), grid_shape=grid_shape, wire_dtype=wire)


@pytest.mark.parametrize("gshape,dtype,grid", [
    ((64, 64), "float32", (1, 1)), ((64, 64), "float32", (2, 2)),
    ((8, 8), "float64", (2, 1)), ((8, 8), "not-a-dtype", (2, 2)),
    ((8, 8), "bfloat16", (2, 2)), ((8, 8), "int8", (2, 4)),
    ((8, 8), "complex128", (2, 4))])
def test_ring_bytes_equals_jax(gshape, dtype, grid):
    assert obs.ring_bytes(gshape, dtype, grid) \
        == jobs.ring_bytes(gshape, dtype, grid)
    assert obs.ring_bytes((64, 64), torch.float32, (2, 2)) \
        == 64 * 64 * 4 * 3 // 4


def test_comm_event_attribution_and_metrics():
    tr = obs.Tracer()
    with obs.metrics_scope() as reg:
        with tr:
            ch = tr.channel("cholesky")
            ch.start()
            with tr.span("step0"):
                tr._on_redist(_fake_record())
                tr._on_redist(_fake_record(wire="bfloat16"))
    ev = tr.comms[0]
    assert ev.label == "[MC,MR]->[STAR,STAR]"
    assert ev.span == "step0" and ev.driver == "cholesky"
    assert ev.bytes == 64 * 64 * 4 * 3 // 4
    assert tr.comms[1].wire_bytes == ev.bytes // 2
    assert tr.redist_counts() == {"[MC,MR]->[STAR,STAR]": 2}
    assert tr.redist_wire_bytes_total() == ev.bytes * 3 // 2
    assert reg.counter_value("redist_calls",
                             label="[MC,MR]->[STAR,STAR]") == 2
    assert reg.counter_value("redist_bytes",
                             label="[MC,MR]->[STAR,STAR]") == 2 * ev.bytes


def test_engine_observer_fires_on_real_redistribute():
    A = et.from_global(np.arange(64.0).reshape(8, 8), et.MC, et.MR,
                       et.Grid(2, 4, device="cpu"))
    tr = obs.Tracer(metrics=False)
    with obs.metrics_scope():
        with tr:
            et.redistribute(A, et.STAR, et.STAR)
    assert tr.redist_counts() == {"[MC,MR]->[STAR,STAR]": 1}
    ev = tr.comms[0]
    assert (ev.path, ev.rounds) == ("chain", 1) and ev.engine_wire_bytes > 0
    with obs.metrics_scope():
        et.redistribute(A, et.VC, et.STAR)
    assert sum(tr.redist_counts().values()) == 1


# ---------------------------------------------------------------------
# PhaseTimer (phase_timings/v1, equal to the JAX package's)
# ---------------------------------------------------------------------

def _timer_doc(pkg_obs):
    t = pkg_obs.PhaseTimer(tracer=pkg_obs.Tracer(metrics=False,
                                                 clock=FakeClock()))
    t.start()
    t.tick("panel", 0)
    t.tick("swap", 0)
    t.tick("panel", 1)
    t.tick("update", 0)
    t.tick("tournament", 1)
    return t


def test_phase_timer_report_structure():
    t = _timer_doc(obs)
    doc = json.loads(t.json(driver="lu", n=64, nb=16))
    assert doc == {
        "schema": "phase_timings/v1",
        "steps": [{"step": 0, "panel": 1.0, "swap": 1.0, "update": 1.0},
                  {"step": 1, "panel": 1.0, "tournament": 1.0}],
        "totals": {"panel": 2.0, "swap": 1.0, "update": 1.0,
                   "tournament": 1.0},
        "total_seconds": 5.0,
        "driver": "lu", "n": 64, "nb": 16,
    }
    assert list(doc["totals"]) == ["panel", "swap", "update", "tournament"]
    assert t.json(driver="lu") == _timer_doc(jobs).json(driver="lu")
    assert obs.PHASES == jobs.PHASES
    assert obs.PHASE_TIMINGS_SCHEMA == jobs.PHASE_TIMINGS_SCHEMA


def test_phase_timer_tick_before_start_is_zero():
    t = obs.PhaseTimer(tracer=obs.Tracer(metrics=False, clock=FakeClock()))
    t.tick("panel", 0)
    assert t.records == [{"phase": "panel", "step": 0, "seconds": 0.0}]


def test_obs_exports_the_jax_names():
    assert set(obs.__all__) == set(jobs.__all__)
    for name in obs.__all__:
        assert hasattr(obs, name), name
