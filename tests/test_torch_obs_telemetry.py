"""Serving telemetry of the port (mirroring ``tests/obs/test_telemetry.py``):
request lifecycle traces, windowed SLO estimators, the fault-triggered
flight recorder, the tracer and registry thread-safety hammers, and the
per-thread export tracks.  The ``serve_timeline/v1``, ``serve_slo/v1``
and ``flight_record/v1`` documents equal the JAX package's for the same
marks under the same virtual clock (all host-only: no JAX computation
runs here)."""
import json
import sys
import threading

import pytest

from elemental_tpu import obs as jobs
from elemental_tpu_torch.obs import Tracer, chrome_trace_doc
from elemental_tpu_torch.obs import metrics as _metrics
from elemental_tpu_torch.obs.flight import FlightRecorder
from elemental_tpu_torch.obs.lifecycle import (EDGES, RequestTrace,
                                               check_timeline)
from elemental_tpu_torch.obs.slo import SLOMonitor, SLOTarget


class StepClock:
    """Deterministic clock: every read advances by ``dt``."""

    def __init__(self, t=0.0, dt=1.0):
        self.t, self.dt = float(t), float(dt)

    def __call__(self):
        self.t += self.dt
        return self.t


# ---------------------------------------------------------------------
# RequestTrace + check_timeline
# ---------------------------------------------------------------------

def test_trace_marks_render_stable_doc():
    tr = RequestTrace(id="r1", clock=StepClock(), tenant="acme", op="hpd")
    tr.annotate(grid="g0", bucket=(16, 2))
    for e in ("submitted", "tenant_queued", "admitted", "staged",
              "dispatched", "collected", "certified", "done"):
        assert e in EDGES
        tr.mark(e)
    doc = tr.to_doc()
    assert doc["schema"] == "serve_timeline/v1"
    assert (doc["id"], doc["tenant"], doc["grid"]) == ("r1", "acme", "g0")
    assert doc["bucket"] == [16, 2]
    rows = doc["edges"]
    assert [r["edge"] for r in rows][0] == "submitted"
    assert rows[0]["dt"] == 0.0
    ts = [r["t"] for r in rows]
    assert ts == sorted(ts)
    # dt is relative to the first mark, in clock units
    assert rows[-1]["dt"] == pytest.approx(ts[-1] - ts[0])
    assert check_timeline(doc, path="fastpath", fleet=True) == []
    # the doc is JSON-serializable as-is
    json.dumps(doc)


def test_trace_annotate_none_is_noop_and_attrs_survive():
    tr = RequestTrace(clock=StepClock(), tenant="t0")
    tr.annotate(grid=None, tenant=None, bucket=None)
    assert tr.tenant == "t0" and tr.grid is None
    tr.mark("submitted", op="hpd")
    tr.mark("shed", reason="quota")
    edges = tr.edges()
    assert edges[1][0] == "shed" and edges[1][2] == {"reason": "quota"}
    assert tr.edge_t("shed") == edges[1][1]
    assert tr.edge_t("done") is None


@pytest.mark.parametrize("rows,kw,frag", [
    # wrong first edge
    ([("admitted", 1.0), ("done", 2.0)], {}, "not 'submitted'"),
    # non-terminal tail
    ([("submitted", 1.0), ("admitted", 2.0)], {}, "terminal edge"),
    # clock ran backwards
    ([("submitted", 2.0), ("admitted", 1.0), ("done", 3.0)], {},
     "not monotone"),
    # ok path missing admission
    ([("submitted", 1.0), ("done", 2.0)], {}, "missing required edge"),
    # reject without a shed attribution
    ([("submitted", 1.0), ("rejected", 2.0)], {}, "without a 'shed'"),
    # fleet timelines must cross the tenant lane
    ([("submitted", 1.0), ("admitted", 2.0), ("done", 3.0)],
     {"fleet": True}, "tenant_queued"),
    # fastpath implies the batch edges
    ([("submitted", 1.0), ("admitted", 2.0), ("done", 3.0)],
     {"path": "fastpath"}, "fastpath missing edge"),
    # escalated/grid paths imply the escalation edge
    ([("submitted", 1.0), ("admitted", 2.0), ("done", 3.0)],
     {"path": "escalated"}, "missing 'escalated'"),
])
def test_check_timeline_catches(rows, kw, frag):
    doc = {"schema": "serve_timeline/v1",
           "edges": [{"edge": e, "t": t} for e, t in rows]}
    problems = check_timeline(doc, **kw)
    assert any(frag in p for p in problems), problems


def test_check_timeline_rejects_foreign_docs():
    assert check_timeline(None) != []
    assert check_timeline({"schema": "serve_result/v1"}) != []
    assert check_timeline({"schema": "serve_timeline/v1", "edges": []}) \
        == ["timeline has no edges"]


def test_trace_mirrors_flight_and_active_tracer():
    clk = StepClock()
    fl = FlightRecorder(clock=clk)
    tr = RequestTrace(id="f7", clock=clk, tenant="acme", flight=fl)
    tracer = Tracer(metrics=False, clock=clk)
    with tracer:
        tr.mark("submitted", op="hpd")
        # a mark's own attr must win over stale attribution (regression:
        # duplicate-kwarg crash when both supplied ``grid``)
        tr.mark("admitted", grid="g1")
    ev = fl.events()
    assert [e["kind"] for e in ev] == ["edge:submitted", "edge:admitted"]
    assert ev[0]["id"] == "f7" and ev[0]["tenant"] == "acme"
    assert ev[1]["grid"] == "g1"
    names = [i.name for i in tracer.instants]
    assert names == ["lifecycle:submitted", "lifecycle:admitted"]
    assert all(i.attrs["flow"] == "f7" for i in tracer.instants)


def test_trace_silent_without_tracer_or_flight():
    tr = RequestTrace(clock=StepClock())
    tr.mark("submitted")       # no active tracer, no flight: no crash
    assert len(tr.edges()) == 1


# ---------------------------------------------------------------------
# SLOMonitor
# ---------------------------------------------------------------------

def _ok(lat_s, tenant="t0", grid="g0", bucket="16x2", status="ok"):
    return {"status": status, "latency_s": lat_s, "tenant": tenant,
            "grid": grid, "bucket": bucket}


def _shed(tenant="t0", grid="g0", bucket="16x2"):
    return {"reason": "quota", "tenant": tenant, "grid": grid,
            "bucket": bucket}


def test_slo_percentiles_nearest_rank():
    mon = SLOMonitor(window=64)
    for ms in range(1, 101):               # 1..100 ms
        mon.record(_ok(ms / 1e3))
    # window=64 keeps the LAST 64 outcomes: 37..100 ms
    doc = mon.snapshot(gauges=False, source="test")
    assert doc["schema"] == "serve_slo/v1" and doc["window"] == 64
    assert doc["source"] == "test"
    (row,) = doc["series"]
    assert row["count"] == 64 and row["sheds"] == 0
    assert row["p50_ms"] == pytest.approx(68.0)
    assert row["p99_ms"] == pytest.approx(100.0)
    assert mon.worst_p99_ms() == pytest.approx(100.0)


def test_slo_burn_rates_and_budgets():
    tgt = SLOTarget(p99_ms=50.0, latency_objective=0.9,
                    error_budget=0.1, shed_budget=0.5)
    mon = SLOMonitor(window=16, targets={"acme": tgt})
    for _ in range(6):
        mon.record(_ok(0.010, tenant="acme"))       # under target
    for _ in range(2):
        mon.record(_ok(0.100, tenant="acme"))       # over 50 ms
    mon.record(_ok(0.010, tenant="acme", status="failed"))
    mon.record(_shed(tenant="acme"))
    (row,) = mon.snapshot(gauges=False)["series"]
    assert row["target"]["p99_ms"] == 50.0
    # 2 of 9 latencies over target, objective allows 10% -> burn 20/9
    assert row["burn"]["latency"] == pytest.approx((2 / 9) / 0.1)
    # 1 failed of 9 completions against a 10% budget
    assert row["error_rate"] == pytest.approx(1 / 9)
    assert row["burn"]["error"] == pytest.approx((1 / 9) / 0.1)
    # 1 shed of 10 outcomes against a 50% budget
    assert row["shed_rate"] == pytest.approx(0.1)
    assert row["burn"]["shed"] == pytest.approx(0.2)


def test_slo_series_keyed_and_sorted_per_tenant_grid_bucket():
    mon = SLOMonitor()
    mon.record(_ok(0.002, tenant="b", grid="g1", bucket="32x2"))
    mon.record(_ok(0.001, tenant="a", grid="g0"))
    mon.record(_shed(tenant="a", grid="g1"))
    rows = mon.snapshot(gauges=False)["series"]
    keys = [(r["tenant"], r["grid"], r["bucket"]) for r in rows]
    assert keys == sorted(keys) and len(keys) == 3
    per = mon.per_tenant_p99_ms()
    assert per == {"a": pytest.approx(1.0), "b": pytest.approx(2.0)}
    assert mon.worst_p99_ms() == pytest.approx(2.0)


def test_slo_gauges_mirrored_to_scoped_registry():
    mon = SLOMonitor()
    mon.record(_ok(0.004, tenant="acme"))
    with _metrics.scoped() as reg:
        mon.snapshot(gauges=True)
        gauges = {r["name"] for r in reg.to_doc()["gauges"]}
    assert {"serve_slo_p99_ms", "serve_slo_burn_latency",
            "serve_slo_burn_error", "serve_slo_burn_shed"} <= gauges


def test_slo_rejects_degenerate_window():
    with pytest.raises(ValueError):
        SLOMonitor(window=0)


# ---------------------------------------------------------------------
# FlightRecorder
# ---------------------------------------------------------------------

def test_flight_ring_bounds_and_dump_accounting():
    clk = StepClock()
    fl = FlightRecorder(capacity=4, clock=clk)
    for i in range(10):
        fl.record("edge:submitted", id=i)
    assert len(fl) == 4
    doc = fl.trigger("manual", source="test")
    assert doc["schema"] == "flight_record/v1"
    assert doc["capacity"] == 4 and doc["recorded"] == 10
    assert doc["dropped"] == 6
    assert [e["id"] for e in doc["events"]] == [6, 7, 8, 9]
    assert [e["seq"] for e in doc["events"]] == [7, 8, 9, 10]
    assert doc["trigger"]["reason"] == "manual"
    assert fl.last_dump() is doc


def test_flight_quota_storm_needs_consecutive_rejects():
    dumped = []
    fl = FlightRecorder(clock=StepClock(), quota_storm_threshold=3,
                        on_dump=dumped.append)
    fl.record("reject", reason="quota")
    fl.record("reject", reason="quota")
    fl.record("reject", reason="shutdown")   # breaks the run
    fl.record("reject", reason="quota")
    fl.record("reject", reason="quota")
    assert not fl.dumps
    fl.record("reject", reason="quota")      # third consecutive: storm
    assert [d["trigger"]["reason"] for d in fl.dumps] == ["quota_storm"]
    assert fl.dumps[0]["trigger"]["rejects"] == 3
    assert dumped == fl.dumps
    # lifecycle-edge mirrors must NOT arm the detector
    fl2 = FlightRecorder(clock=StepClock(), quota_storm_threshold=2)
    for _ in range(5):
        fl2.record("edge:shed", reason="quota")
    assert not fl2.dumps


def test_flight_dump_bit_identical_under_virtual_clock():
    def run():
        fl = FlightRecorder(capacity=8, clock=StepClock())
        for i in range(12):
            fl.record("edge:admitted", id=f"f{i}", grid="g0")
        return fl.trigger("chaos_fault", source="replay")

    assert json.dumps(run(), sort_keys=True) \
        == json.dumps(run(), sort_keys=True)


def test_flight_unknown_trigger_reason_still_dumps():
    fl = FlightRecorder(clock=StepClock())
    doc = fl.trigger("novel_reason")
    assert doc["trigger"]["reason"] == "novel_reason"
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)


# ---------------------------------------------------------------------
# thread-safety hammers (these fail without the registry/tracer locks:
# every update is a read-modify-write)
# ---------------------------------------------------------------------

@pytest.fixture
def aggressive_switching():
    """Shrink the GIL switch interval so lost updates surface reliably."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(prev)


def _hammer(fn, nthreads=8):
    start = threading.Barrier(nthreads)

    def body():
        start.wait()
        fn()

    ts = [threading.Thread(target=body) for _ in range(nthreads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
        assert not t.is_alive()


def test_metrics_registry_hammer(aggressive_switching):
    reg = _metrics.MetricsRegistry()
    iters, nthreads = 3000, 8

    def body():
        for i in range(iters):
            reg.inc("hits", op="hpd")
            reg.observe("lat_seconds", 0.001)

    _hammer(body, nthreads)
    total = iters * nthreads
    assert reg.counter_value("hits", op="hpd") == total
    (h,) = reg.to_doc()["histograms"]
    assert h["count"] == total
    assert h["sum"] == pytest.approx(0.001 * total)
    assert h["buckets"][-1]["count"] == total


def test_tracer_hammer_unique_calls_and_no_lost_records(
        aggressive_switching):
    tracer = Tracer(metrics=False)
    iters, nthreads = 400, 8

    def body():
        for i in range(iters):
            ch = tracer.channel("lu")
            ch.start()
            ch.tick("panel", i)
            with tracer.span("work", i=i):
                tracer.instant("health:ok", i=i)

    _hammer(body, nthreads)
    total = iters * nthreads
    # channel ids are allocated under the lock: all distinct, none lost
    calls = [r.call for r in tracer.phases]
    assert len(calls) == total and len(set(calls)) == total
    assert len(tracer.spans) == total
    assert len(tracer.instants) == total
    # nesting state is thread-local: concurrent spans never stack
    assert {s.depth for s in tracer.spans} == {0}
    assert len({s.thread for s in tracer.spans}) == nthreads


def test_request_trace_hammer_keeps_every_mark(aggressive_switching):
    clk = StepClock()
    fl = FlightRecorder(capacity=100_000, clock=clk)
    tr = RequestTrace(clock=clk, flight=fl)
    iters, nthreads = 500, 8
    _hammer(lambda: [tr.mark("staged") for _ in range(iters)], nthreads)
    assert len(tr.edges()) == iters * nthreads
    assert len(fl) == iters * nthreads
    seqs = [e["seq"] for e in fl.events()]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)


# ---------------------------------------------------------------------
# exporter: per-thread tracks + flow events
# ---------------------------------------------------------------------

def test_export_threads_get_own_tracks_and_flow_chain():
    clk = StepClock(dt=0.001)
    tracer = Tracer(metrics=False, clock=clk)

    def worker(tag):
        with tracer.span(f"serve:{tag}"):
            tracer.instant("lifecycle:admitted", flow="f0", grid=tag)

    with tracer.span("serve:fleet"):
        tracer.instant("lifecycle:submitted", flow="f0")
        for tag in ("w0", "w1"):
            t = threading.Thread(
                target=worker, args=(tag,),
                name=f"elemental-serve-worker:{tag}")
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        tracer.instant("lifecycle:done", flow="f0")
        tracer.instant("health:flag")          # flowless: never linked

    doc = chrome_trace_doc(tracer, mode="test")
    evs = doc["traceEvents"]
    tracks = {e["args"]["name"]: e["tid"] for e in evs
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "elemental-serve-worker:w0" in tracks
    assert "elemental-serve-worker:w1" in tracks
    assert tracks["elemental-serve-worker:w0"] \
        != tracks["elemental-serve-worker:w1"]
    # each worker's span rides ITS track, not the home thread's
    spans = {e["name"]: e["tid"] for e in evs if e["ph"] == "X"}
    assert spans["serve:w0"] == tracks["elemental-serve-worker:w0"]
    assert spans["serve:w1"] == tracks["elemental-serve-worker:w1"]

    flow = [e for e in evs if e["ph"] in ("s", "t", "f")]
    assert [e["ph"] for e in flow] == ["s", "t", "t", "f"]
    assert all(e["name"] == "serve:req" and e["cat"] == "lifecycle"
               and e["id"] == "f0" for e in flow)
    ts = [e["ts"] for e in flow]
    assert ts == sorted(ts)
    # the middle hops land on the workers' event tracks: Perfetto draws
    # arrows crossing track groups, the acceptance criterion
    assert {flow[1]["tid"], flow[2]["tid"]} \
        == {tracks["elemental-serve-worker:w0 events"],
            tracks["elemental-serve-worker:w1 events"]}
    assert flow[0]["tid"] == flow[3]["tid"]    # submit/done: home events


def test_export_single_instant_flow_not_linked():
    tracer = Tracer(metrics=False, clock=StepClock())
    tracer.instant("lifecycle:submitted", flow="lonely")
    evs = chrome_trace_doc(tracer)["traceEvents"]
    assert not [e for e in evs if e["ph"] in ("s", "t", "f")]


# ---------------------------------------------------------------------
# the documents equal the JAX package's
# ---------------------------------------------------------------------

def _timeline(mod_lifecycle, mod_flight, mod_tracer):
    clk = StepClock()
    fl = mod_flight.FlightRecorder(capacity=6, clock=clk)
    tr = mod_lifecycle.RequestTrace(id="r9", clock=clk, tenant="acme",
                                    op="hpd", flight=fl)
    tracer = mod_tracer.Tracer(metrics=False, clock=clk)
    with tracer:
        tr.annotate(grid="g1", bucket=(32, 4))
        for e in ("submitted", "tenant_queued", "admitted", "staged",
                  "dispatched", "collected", "certified", "done"):
            tr.mark(e, attempt=1 if e == "staged" else None)
    fl.record("reject", reason="quota")
    return (tr.to_doc(), fl.trigger("manual", source="parity"),
            [(i.name, i.attrs) for i in tracer.instants])


def test_timeline_flight_and_instants_equal_jax():
    from elemental_tpu.obs import flight as jfl, lifecycle as jlc
    from elemental_tpu_torch.obs import flight as tfl, lifecycle as tlc
    from elemental_tpu_torch import obs as tobs
    got = _timeline(tlc, tfl, tobs)
    want = _timeline(jlc, jfl, jobs)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert check_timeline(got[0], path="fastpath", fleet=True) == []


@pytest.mark.parametrize("window", [4, 64])
def test_slo_snapshot_equals_jax(window):
    from elemental_tpu.obs.slo import SLOMonitor as JSLOMonitor
    from elemental_tpu.obs.slo import SLOTarget as JSLOTarget

    def feed(mon):
        for k in range(12):
            mon.record(_ok(0.001 * (k + 1), tenant=("a", "b")[k % 2],
                           status="failed" if k == 5 else "ok"))
        mon.record(_shed(tenant="b", grid="g1"))
        return mon.snapshot(gauges=False, source="parity")

    tgt = dict(p99_ms=5.0, latency_objective=0.9, error_budget=0.1,
               shed_budget=0.2)
    got = feed(SLOMonitor(window=window, targets={"a": SLOTarget(**tgt)}))
    want = feed(JSLOMonitor(window=window,
                            targets={"a": JSLOTarget(**tgt)}))
    assert got == want
