"""The port's serving front door against the JAX package's: every public
name with its signature, admission decisions and ``serve_reject/v1``
documents, retry delays, circuit-breaker transitions and gauges, the
degradation ladder, and the fair scheduler's pop order -- the same
seeded inputs and the same injected clock to both."""
import inspect
import re

import numpy as np
import pytest

import elemental_tpu.serve as jserve
import elemental_tpu_torch as et
import elemental_tpu_torch.serve as tserve
from elemental_tpu.obs import metrics as jmetrics
from elemental_tpu_torch.obs import metrics as tmetrics

from .torch_serve_common import (FakeClock, cpu_default_grid,  # noqa: F401
                                 diag_dom, same, spd)


@pytest.mark.parametrize("name", sorted(jserve.__all__))
def test_every_jax_serve_name_has_the_jax_signature(name):
    j, t = getattr(jserve, name), getattr(tserve, name)
    if callable(j) and not isinstance(j, type) or inspect.isclass(j):
        target_j = j.__init__ if inspect.isclass(j) else j
        target_t = t.__init__ if inspect.isclass(t) else t
        assert str(inspect.signature(target_t)) \
            == str(inspect.signature(target_j))
    else:
        assert t == j


def test_package_exports_the_service_and_the_deadline():
    assert et.serve is tserve
    assert et.SolverService is tserve.SolverService
    assert et.Deadline is tserve.Deadline


def _cases(rng):
    """The JAX admission tests' requests: valid, aliased, vector rhs,
    malformed, tall least squares."""
    n = 12
    A, B = diag_dom(rng, n), rng.normal(size=(n, 2))
    return [("lu", A, B), ("cholesky", spd(rng, n), B),
            ("lu", diag_dom(rng, 8), rng.normal(size=8)),
            ("svd", A, B), ("lu", rng.normal(size=(4, 5)), B),
            ("lu", A, rng.normal(size=(5, 2))),
            ("qr", rng.normal(size=(20, 12)), rng.normal(size=(20, 3))),
            ("lstsq", rng.normal(size=(5, 9)), rng.normal(size=(5, 1))),
            ("lu", np.arange(16).reshape(4, 4), np.ones((4, 1)))]


def _admit_all(pkg, clock, **kw):
    rng = np.random.default_rng(3)
    ctrl = pkg.AdmissionController(clock=clock, **kw)
    out = []
    for i, (op, A, B) in enumerate(_cases(rng)):
        dl = pkg.Deadline(0.5 + i, clock=clock)
        r = ctrl.admit(op, A, B, deadline=dl, queue_depth=i % 3,
                       tenant=f"t{i % 2}")
        if isinstance(r, dict):
            out.append(r)
        else:
            out.append({"id": r.id, "op": r.op, "bucket": r.bucket.key(),
                        "n": r.n, "nrhs": r.nrhs, "A": r.A.tolist(),
                        "B": r.B.tolist(), "tenant": r.tenant,
                        "submitted": r.submitted,
                        "deadline": r.deadline.to_doc()})
        clock.advance(0.25)
    return out, ctrl


@pytest.mark.parametrize("kw", [{}, {"flops_per_s": 1.0, "max_batch": 2},
                                {"hbm_bytes": 1024},
                                {"hbm_bytes": 1024, "shed": False}],
                         ids=["default", "slow", "tiny_hbm", "noshed"])
def test_admission_decisions_and_rejects_equal(kw):
    j, jc = _admit_all(jserve, FakeClock(), **kw)
    t, tc = _admit_all(tserve, FakeClock(), **kw)
    for doc in j + t:
        # the static peak is each package's own estimate (the port's
        # closed form, JAX's liveness walk): the decision and the rest of
        # the detail are equal
        if doc.get("reason") == "memory_pressure":
            doc["detail"] = re.sub(r"peak \d+ B", "peak _ B", doc["detail"])
    assert same(t, j) == []
    assert tc._ewma == jc._ewma


def test_ewma_wait_estimates_and_reject_doc_equal():
    out = []
    for pkg in (jserve, tserve):
        ctrl = pkg.AdmissionController(max_batch=4)
        b = pkg.make_bucket("hpd", 100, 3, np.float32)
        row = [ctrl.estimate_batch_s(b), ctrl.estimated_wait_s(b, 9)]
        for s in (0.5, 0.25, 1.0):
            ctrl.observe_batch(b, s)
            row += [ctrl.estimate_batch_s(b), ctrl.estimated_wait_s(b, 5)]
        clock = FakeClock()
        dl = pkg.Deadline(2.0, clock=clock)
        clock.advance(0.5)
        row.append(pkg.reject_doc("quota", bucket=b, queue_depth=3,
                                  estimate_s=1.5, deadline=dl,
                                  detail="x", grid="g1", tenant="acme"))
        row.append([pkg.make_bucket("lstsq", n, 2, np.float64, m=m).key()
                    for n, m in ((12, 20), (100, 300), (16, 16))])
        out.append(row)
    assert same(out[1], out[0]) == []
    with pytest.raises(ValueError):
        tserve.reject_doc("nope")


def test_retry_delays_equal():
    for kw in ({"retries": 3, "base_s": 0.1, "jitter": 0.5, "seed": 42},
               {"retries": 2, "base_s": 10.0, "jitter": 0.0, "seed": 0}):
        clock_j, clock_t = FakeClock(), FakeClock()
        pj, pt = jserve.RetryPolicy(**kw), tserve.RetryPolicy(**kw)
        dj, dt = jserve.Deadline(25.0, clock_j), tserve.Deadline(25.0,
                                                                  clock_t)
        for rid in (0, 7, 11):
            for att in (1, 2, 3):
                assert pt.delay_s(rid, att) == pj.delay_s(rid, att)
                assert pt.delay_s(rid, att, dt) == pj.delay_s(rid, att, dj)
            clock_j.advance(12.0)
            clock_t.advance(12.0)


def _breaker_story(pkg, metrics):
    """The JAX policy tests' cycle: trip, reject during cooldown,
    half-open probe failure, re-open, probe success, close."""
    clock = FakeClock()
    with metrics.scoped() as reg:
        br = pkg.CircuitBreaker("lu__b16x2__float64", threshold=3,
                                cooldown_s=5.0, clock=clock, grid="g0")
        log = []
        for step in ("f", "s", "f", "f", "f", "a", "t4", "a", "t2", "a",
                     "f", "a", "t5", "a", "s", "a", "f"):
            if step == "f":
                br.record_failure()
            elif step == "s":
                br.record_success()
            elif step == "a":
                log.append(br.allow())
            else:
                clock.advance(float(step[1:]))
            log.append(br.to_doc())
        doc = reg.to_doc()
    return log, doc


def test_circuit_breaker_transitions_and_gauges_equal():
    j, jdoc = _breaker_story(jserve, jmetrics)
    t, tdoc = _breaker_story(tserve, tmetrics)
    assert same(t, j) == []
    assert same(tdoc, jdoc) == []


@pytest.mark.parametrize("op", ["lu", "hpd"])
def test_select_ladder_equal(op):
    for p in (0.0, 0.49, 0.5, 2.0):
        lj = jserve.select_ladder(op, p)
        lt = tserve.select_ladder(op, p)
        assert [(r.name, r.refine, r.refactor) for r in lt] \
            == [(r.name, r.refine, r.refactor) for r in lj]
    assert (tserve.CLOSED, tserve.OPEN, tserve.HALF_OPEN) \
        == (jserve.CLOSED, jserve.OPEN, jserve.HALF_OPEN)


class _Item:
    def __init__(self, name):
        self.name = name


def _drr(pkg, metrics):
    """A burst tenant, a light one and a weighted one: the DRR pop order,
    a router un-pop, quotas and the snapshot."""
    with metrics.scoped() as reg:
        s = pkg.FairScheduler(quotas={"heavy": {"share": 2.0},
                                      "capped": pkg.TenantQuota(
                                          max_outstanding=2)})
        for i in range(12):
            s.push("burst", _Item(f"b{i}"), cost=1.0 + (i % 3))
        for i in range(3):
            s.push("light", _Item(f"l{i}"), cost=2.0)
            s.push("heavy", _Item(f"h{i}"), cost=4.0)
        order = []
        for k in range(10):
            it = s.pop()
            order.append(it.name)
            if k == 4:
                s.push_front("light", it, cost=2.0)
                order.append("unpop")
        order += [it.name for it in s.flush()]
        order.append(s.pop())
        doc = reg.to_doc()
    return order, s.to_doc(), s.quota("capped").max_outstanding, doc


def test_fair_scheduler_pop_order_equal():
    j = _drr(jserve, jmetrics)
    t = _drr(tserve, tmetrics)
    assert same(list(t), list(j)) == []
    assert tserve.DEFAULT_TENANT == jserve.DEFAULT_TENANT
    with pytest.raises(ValueError):
        tserve.TenantQuota(share=0.0)
