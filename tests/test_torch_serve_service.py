"""The port's ``SolverService`` against the JAX package's, request by
request: the same seeded workloads under the same injected clock give
equal ``serve_result/v1`` / ``serve_reject/v1`` documents field by field
(statuses, paths, rungs, retries, ``bisected``, reject reasons exactly;
residuals, certificates' floats and timelines' attributes to 1e-12),
equal serve metrics, and solutions within 1e-12 (f64) -- on the fast
path, under a poisoned batch (bisection), with the breaker open
(escalation through ``certified_solve``), on the lstsq escalation, past
deadlines and under load shedding.  JAX runs on a 1x1 grid, the port on
a 1x1 CPU grid."""
import numpy as np
import pytest

import elemental_tpu.serve as jserve
import elemental_tpu_torch.serve as tserve
from elemental_tpu.obs import metrics as jmetrics
from elemental_tpu_torch.obs import metrics as tmetrics

from .torch_serve_common import (X_TOL, FakeClock,  # noqa: F401
                                 cpu_default_grid, diag_dom, jax_grid,
                                 port_grid, same, spd)

PKGS = ((jserve, jmetrics, jax_grid), (tserve, tmetrics, port_grid))


def _serve_metrics(doc: dict) -> dict:
    """The ``serve_*`` rows of an ``obs_metrics/v1`` document."""
    return {k: [r for r in doc[k] if r["name"].startswith("serve_")]
            for k in ("counters", "gauges", "histograms")}


def _both(scenario, **svc_kw):
    """Run ``scenario(svc, clock, rng) -> ids`` on each package; returns
    the two ``(results, solutions, metrics, extra)`` tuples."""
    out = []
    for pkg, metrics, grid in PKGS:
        clock = FakeClock()
        rng = np.random.default_rng(40)
        with metrics.scoped() as reg:
            svc = pkg.SolverService(grid(), clock=clock, sleep=clock.sleep,
                                    **svc_kw)
            extra = scenario(svc, clock, rng)
            doc = reg.to_doc()
        out.append((svc.results, svc.solutions, _serve_metrics(doc), extra,
                    {k: b.to_doc() for k, b in svc.breakers.items()}))
    return out


def _check(j, t):
    assert same(t[0], j[0]) == []
    assert sorted(t[1]) == sorted(j[1])
    for rid in j[1]:
        np.testing.assert_allclose(t[1][rid], j[1][rid], rtol=0, atol=X_TOL)
    assert same(t[2], j[2]) == []
    assert same(t[3], j[3]) == []
    assert same(t[4], j[4]) == []
    for doc in t[0].values():
        if doc.get("status") == "ok":
            assert doc["residual"] <= doc["tol"]


def _mixed(rng, count=9):
    out = []
    for i in range(count):
        n = (12, 16, 9)[i % 3]
        if i % 3 == 2:
            out.append(("lstsq", rng.normal(size=(n + 7, n)),
                        rng.normal(size=(n + 7, 2))))
        elif i % 2:
            out.append(("lu", diag_dom(rng, n), rng.normal(size=(n, 2))))
        else:
            out.append(("hpd", spd(rng, n), rng.normal(size=(n, 2))))
    return out


def test_fastpath_outcomes_equal():
    def scenario(svc, clock, rng):
        ids = []
        for op, A, B in _mixed(rng):
            ids.append(svc.submit(op, A, B))
            clock.advance(0.01)
        return [ids, svc.drain(), svc.executor.cache.stats()["entries"]]
    j, t = _both(scenario, max_batch=4)
    _check(j, t)
    assert all(d["status"] == "ok" and d["path"] == "fastpath"
               for d in t[0].values())


def test_poisoned_batch_bisects_alone_equal():
    """A singular request among good ones: the batch fails
    certification, bisection re-executes the halves, the poisoned
    request escapes alone to the certified ladder and fails structured
    (singular), its batch-mates certify."""
    def scenario(svc, clock, rng):
        n = 12
        good = [diag_dom(rng, n) for _ in range(5)]
        B = rng.normal(size=(n, 1))
        ids = [svc.submit("lu", A, B) for A in good[:3]]
        ids.append(svc.submit("lu", np.ones((n, n)), B))
        ids += [svc.submit("lu", A, B) for A in good[3:]]
        svc.drain()
        return ids
    j, t = _both(scenario, max_batch=8, retries=0)
    _check(j, t)
    bad = t[0][3]
    assert bad["status"] == "failed" and bad["bisected"] is True
    assert bad["certificate"]["singular"] is True
    assert sum(d["status"] == "ok" for d in t[0].values()) == 5


def test_breaker_open_escalation_equal():
    """Two failing batches trip the breaker; submissions reject fast
    while it is open, queued ones escalate through ``certified_solve``
    (the port's kernels' path), and after the cooldown a probe closes
    it."""
    def scenario(svc, clock, rng):
        n = 8
        B = rng.normal(size=(n, 1))
        docs = []
        for _ in range(2):
            docs.append(svc.submit("lu", np.ones((n, n)), B))
            svc.drain()
        docs.append(svc.submit("lu", diag_dom(rng, n), B))
        docs.append(svc.submit("hpd", spd(rng, n), B))
        svc.drain()
        clock.advance(11.0)
        docs.append(svc.submit("lu", diag_dom(rng, n), B))
        svc.drain()
        return docs
    j, t = _both(scenario, breaker_threshold=2, breaker_cooldown_s=10.0,
                 retries=0, max_batch=1)
    _check(j, t)
    assert t[3][2]["reason"] == "breaker_open"
    assert [d["path"] for d in t[0].values()] \
        == ["escalated", "escalated", "fastpath", "fastpath"]
    assert t[4]["lu__b8x1__float64"]["state"] == "closed"


def test_queued_requests_escalate_when_the_breaker_opens_equal():
    def scenario(svc, clock, rng):
        n = 8
        B = rng.normal(size=(n, 1))
        ids = [svc.submit("lu", np.ones((n, n)), B),
               svc.submit("lu", diag_dom(rng, n), B),
               svc.submit("hpd", spd(rng, n), B)]
        svc.drain()
        return ids
    j, t = _both(scenario, breaker_threshold=1, breaker_cooldown_s=1e9,
                 retries=0, max_batch=1)
    _check(j, t)
    assert t[0][1]["path"] == "escalated" and t[0][1]["status"] == "ok"


def test_lstsq_escalation_equal():
    def scenario(svc, clock, rng):
        ids = []
        for m, n in ((24, 10), (40, 16)):
            X, doc = svc.solve("qr", rng.normal(size=(m, n)),
                               rng.normal(size=(m, 2)))
            ids.append(doc["id"])
        return ids
    j, t = _both(scenario, fastpath=False)
    _check(j, t)
    assert [d["rung"] for d in t[0].values()] == ["grid_qr", "grid_qr"]


def test_deadline_timeouts_equal():
    """Expired in the queue (dropped before launch), expired before an
    escalation (timed out at the ladder's door), and the deadline docs."""
    def scenario(svc, clock, rng):
        n = 8
        ids = [svc.submit("lu", diag_dom(rng, n), rng.normal(size=(n, 1))),
               svc.submit("lu", diag_dom(rng, n), rng.normal(size=(n, 1)),
                          budget_s=1.0),
               svc.submit("hpd", spd(rng, n), rng.normal(size=(n, 1)),
                          budget_s=5.0)]
        clock.advance(2.0)
        svc.drain()
        svc.fastpath = False
        ids.append(svc.submit("lu", diag_dom(rng, n),
                              rng.normal(size=(n, 1)), budget_s=1.0))
        clock.advance(1.5)
        svc.drain()
        return ids
    j, t = _both(scenario)
    _check(j, t)
    st = [t[0][i]["status"] for i in range(4)]
    assert st == ["ok", "timed_out", "ok", "timed_out"]
    assert t[0][1]["path"] == "dropped"


def test_load_shedding_and_shutdown_equal():
    def scenario(svc, clock, rng):
        A, B = diag_dom(rng, 8), rng.normal(size=(8, 1))
        out = [svc.submit("lu", A, B), svc.submit("lu", A, B, budget_s=5.0),
               svc.submit("lu", A, B, budget_s=1e9),
               svc.submit("svd", A, B)]
        out.append(svc.shutdown(drain=False))
        out.append(svc.submit("lu", A, B))
        out.append(svc.shutdown())
        return out
    j, t = _both(scenario, flops_per_s=1.0, max_batch=2)
    _check(j, t)
    assert t[3][1]["reason"] == "queue_pressure"
    assert t[3][3]["reason"] == "bad_request"
    assert t[3][5]["reason"] == "shutdown"


@pytest.mark.parametrize("op", ["hpd", "lu", "lstsq"])
def test_escalation_holds_the_device_gate_alone(op, monkeypatch):
    """An escalation runs its drivers with the device gate held
    exclusive by its own thread: their graph captures (CALU's pivot
    sweeps on a member's 2x2 grid) run beside no other serve-layer
    device call."""
    import threading
    import elemental_tpu_torch.lapack as tlapack
    from elemental_tpu_torch.serve import service as tservice
    from elemental_tpu_torch.serve.executor import DEVICE_GATE
    held = []

    def spy(fn):
        def wrapped(*a, **kw):
            held.append(DEVICE_GATE._writer is threading.current_thread())
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tservice, "certified_solve",
                        spy(tservice.certified_solve))
    monkeypatch.setattr(tlapack, "least_squares",
                        spy(tlapack.least_squares))
    rng = np.random.default_rng(3)
    n = 12
    A = {"hpd": spd(rng, n), "lu": diag_dom(rng, n),
         "lstsq": rng.standard_normal((2 * n, n))}[op]
    B = rng.standard_normal((A.shape[0], 2))
    svc = tserve.SolverService(port_grid(), fastpath=False)
    _, doc = svc.solve(op, A, B)
    assert doc["status"] == "ok" and doc["path"] == "escalated"
    assert held and all(held)
    assert DEVICE_GATE._writer is None


@pytest.mark.parametrize("cli,argv", [
    ("elemental_tpu_torch.serve.__main__", ["smoke"]),
    ("elemental_tpu_torch.obs.__main__", ["serve", "--smoke"]),
])
def test_serve_clis_refuse_a_missing_card(cli, argv, monkeypatch, capsys):
    """Without ``--device cpu`` the serve CLIs run on ``cuda:0``; with no
    card they exit 2 at once instead of starting workers that cannot
    reach it."""
    import importlib

    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert importlib.import_module(cli).main(argv) == 2
    assert "--device cpu" in capsys.readouterr().err
