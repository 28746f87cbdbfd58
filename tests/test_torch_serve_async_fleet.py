"""The port's pipelined front and fleet: the async worker's solutions
bit-equal to the synchronous service's on the same requests, streamed
completions, structured shutdown flushes and no leaked worker thread;
the fleet's quota rejects, routing, provenance, lifecycle timelines and
``stats()`` equal to the JAX package's under a virtual clock (sync
members), and a pipelined fleet's outcomes.  Every wait has a timeout."""
import threading

import numpy as np
import pytest

import elemental_tpu.serve as jserve
import elemental_tpu_torch.serve as tserve
from elemental_tpu.obs import metrics as jmetrics
from elemental_tpu_torch.obs import metrics as tmetrics
from elemental_tpu_torch.obs.lifecycle import check_timeline

from .torch_serve_common import (FakeClock, cpu_default_grid,  # noqa: F401
                                 diag_dom, port_grid, same, spd)

#: the keys of ``serve_result/v1`` that do not depend on timing or on
#: how requests were grouped into batches (``bench_serve.py``'s)
SEM_KEYS = ("status", "path", "rung", "op", "n", "nrhs", "bucket",
            "retries", "bisected", "timed_out")


def _workload(seed=50, count=12):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = (12, 16, 10)[i % 3]
        if i % 4 == 3:
            out.append(("lstsq", rng.normal(size=(n + 5, n)),
                        rng.normal(size=(n + 5, 2))))
        elif i % 2:
            out.append(("lu", diag_dom(rng, n), rng.normal(size=(n, 2))))
        else:
            out.append(("hpd", spd(rng, n), rng.normal(size=(n, 2))))
    return out


def _leaked() -> bool:
    return any(t.name.startswith("elemental-serve-worker") and t.is_alive()
               for t in threading.enumerate())


def test_async_front_is_bit_equal_to_the_sync_service():
    work = _workload()
    svc = tserve.SolverService(port_grid(), max_batch=4)
    ids = [svc.submit(op, A, B) for op, A, B in work]
    svc.drain()
    front = tserve.AsyncSolverService(grid=port_grid(), max_batch=4,
                                      autostart=False)
    assert front.donate is False       # the CPU entries have no buffers
    streamed = []
    futs = [front.submit(op, A, B, callback=lambda f: streamed.append(f.id))
            for op, A, B in work]
    front.start()
    outs = [f.result(timeout=60) for f in futs]
    front.shutdown(drain=True)
    assert not _leaked() and sorted(streamed) == sorted(f.id for f in futs)
    for rid, (x, doc) in zip(ids, outs):
        assert np.array_equal(x, svc.solutions[rid])
        assert {k: doc[k] for k in SEM_KEYS} \
            == {k: svc.results[rid][k] for k in SEM_KEYS}
        assert check_timeline(doc["timeline"], path=doc["path"]) == []
    st = front.pipeline_stats()
    assert set(st) == {"device_busy_s", "wall_s", "occupancy"}
    assert 0.0 <= st["occupancy"]


def test_async_hard_stop_flushes_structured():
    cell, front = tserve.run_async_shutdown_cell(port_grid())
    assert cell["violations"] == [] and cell["flushed"] > 0
    assert not _leaked()
    late = front.submit("hpd", np.eye(4), np.ones((4, 1)))
    assert late.result(timeout=5)[1]["reason"] == "shutdown"


def _fleet_story(pkg, metrics):
    """Two tenants (one under a quota) on a 2-member sync fleet under a
    virtual clock: routing by backlog x EWMA, quota rejects, provenance,
    timelines; then the fleet's snapshot."""
    clock = FakeClock()
    rng = np.random.default_rng(51)
    with metrics.scoped() as reg:
        fleet = pkg.SolverFleet(grids=2, pipelined=False, shed=False,
                                max_batch=2, clock=clock, sleep=clock.sleep,
                                quotas={"q": pkg.TenantQuota(
                                    max_outstanding=3),
                                    "w": {"share": 2.0}})
        futs = []
        for i in range(10):
            n = (12, 16)[i % 2]
            A = spd(rng, n) if i % 3 else diag_dom(rng, n)
            op = "hpd" if i % 3 else "lu"
            futs.append(fleet.submit(op, A, rng.normal(size=(n, 1)),
                                     tenant=("q", "w", None)[i % 3]))
            clock.advance(0.5)
        stats_mid = fleet.stats()
        fleet.drain()
        docs = [f.result(timeout=0)[1] for f in futs]
        grids = [f.grid for f in futs]
        stats_end = fleet.stats()
        fleet.shutdown(drain=True)
        late = fleet.submit("hpd", np.eye(4), np.ones((4, 1)))
        dump = fleet.flight.last_dump()
        mdoc = reg.to_doc()
    serve_rows = {k: [r for r in mdoc[k] if r["name"].startswith("serve_")]
                  for k in ("counters", "gauges")}
    return (docs, grids, stats_mid, stats_end, late.result(timeout=0)[1],
            dump, fleet.slo.snapshot(source="t"), serve_rows)


def test_fleet_quotas_routing_and_timelines_equal_to_jax():
    j = _fleet_story(jserve, jmetrics)
    t = _fleet_story(tserve, tmetrics)
    assert same(list(t), list(j)) == []
    docs = t[0]
    assert sum(d.get("reason") == "quota" for d in docs) >= 1
    assert {d.get("grid") for d in docs if d.get("status") == "ok"} \
        == {"g0", "g1"}
    for d in docs:
        if d.get("status") == "ok":
            assert check_timeline(d["timeline"], path=d["path"],
                                  fleet=True) == []
    assert t[3]["members"][0]["shape"] == [2, 2]


def test_partition_and_rank_slots():
    slots = tserve.fleet._fleet_device_order()
    assert [s.id for s in slots] == list(range(8))
    assert all(s.device.type == "cpu" for s in slots)
    parts = tserve.partition_devices(slots, [3, 4])
    assert [len(p) for p in parts] == [3, 4]
    with pytest.raises(ValueError):
        tserve.partition_devices(slots, 3)
    fleet = tserve.SolverFleet(slots, grids=[1, 2, 4], pipelined=False)
    assert [(s.grid.height, s.grid.width) for s in fleet.services] \
        == [(1, 1), (1, 2), (2, 2)]
    assert [s.executor.device.id for s in fleet.services] == [0, 1, 3]
    fleet.shutdown()


def test_pipelined_fleet_serves_every_request():
    work = _workload(seed=52, count=16)
    fleet = tserve.SolverFleet(grids=2, depth=3, shed=False, max_batch=2)
    futs = [fleet.submit(op, A, B, tenant=f"t{i % 2}")
            for i, (op, A, B) in enumerate(work)]
    outs = [f.result(timeout=60) for f in futs]
    fleet.shutdown(drain=True)
    assert not _leaked()
    assert all(d["status"] == "ok" for _, d in outs)
    assert {d["grid"] for _, d in outs} == {"g0", "g1"}
    for (op, A, B), (x, d) in zip(work, outs):
        meas = tserve.ls_residual if op == "lstsq" else tserve.residual
        assert meas(A, B, x) <= d["tol"]
        assert check_timeline(d["timeline"], path=d["path"],
                              fleet=True) == []
