"""The port's driver tracing held against the JAX package's.

For each tuned driver (``cholesky``, ``lu``, ``qr``, ``gemm``, ``trsm``,
``herk``) at n = 32, nb = 16 on 1x1 and 2x2 grids, the same float64
input runs under an active ``Tracer`` with a step clock and an explicit
``PhaseTimer`` (the fan-out path) in both packages.  With the step clock
every timestamp is a count of clock reads, so the (driver, phase, step)
sequence, the ``phase_timings/v1`` document, the whole Chrome trace
(spans, phase lanes, collective instants with their ring-model bytes)
and the ``op_calls`` counters must be EQUAL, not close.  Each JAX
reference is computed once per module.

``cholesky`` and ``lu`` run with ``crossover = n/2``, so a 2x2 run ticks
both the distributed steps and the crossover ``tail``.  The ``timer=``
cases of the guarded drivers and the solve wrappers, and the recovery
span / health instants of the resilience layer, close the file."""
import functools

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu import obs as jobs
from elemental_tpu_torch import obs as tobs

GRIDS = [(1, 1), (2, 2)]
DRIVERS = ("cholesky", "lu", "qr", "gemm", "trsm", "herk")
N, NB = 32, 16


class StepClock:
    """Deterministic clock: every read advances by one."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _inputs():
    rng = np.random.default_rng(12)
    F = rng.normal(size=(N, N))
    S = F @ F.T / N + N * np.eye(N)
    B = rng.normal(size=(N, N))
    return F + N * np.eye(N), S, B


def _call(pkg, driver, grid, timer):
    """Run ``driver`` of package ``pkg`` (``el`` or ``et``) once."""
    G, S, B = _inputs()
    A = pkg.from_global(S if driver in ("cholesky", "trsm", "herk") else G,
                        pkg.MC, pkg.MR, grid=grid)
    Bd = pkg.from_global(B, pkg.MC, pkg.MR, grid=grid)
    if driver == "cholesky":
        return pkg.cholesky(A, nb=NB, crossover=N // 2, timer=timer)
    if driver == "lu":
        return pkg.lu(A, nb=NB, crossover=N // 2, timer=timer)[0]
    if driver == "qr":
        return pkg.qr(A, nb=NB, timer=timer)[0]
    if driver == "gemm":
        out = pkg.gemm(A, Bd, alg="C", nb=NB)
    elif driver == "trsm":
        out = pkg.trsm("L", "L", "N", A, Bd, nb=NB)
    else:
        out = pkg.herk("L", A, nb=NB)
    return out


def _traced(pkg, obs, driver, grid):
    """One traced run: (phase sequence, phase_timings/v1 of the explicit
    timer, Chrome trace, op_calls counters, global result)."""
    clock = StepClock()
    tracer = obs.Tracer(metrics=False, clock=clock)
    timer = obs.PhaseTimer(tracer=obs.Tracer(metrics=False, clock=clock))
    with obs.metrics_scope() as reg:
        with tracer:
            with tracer.span("run", driver=driver):
                out = _call(pkg, driver, grid,
                            timer if driver in ("cholesky", "lu", "qr")
                            else None)
        ops = {tuple(sorted(dict(labels).items())): v for (_, labels), v
               in reg.counters("op_calls").items()}
    seq = [(r.driver, r.phase, r.step) for r in tracer.phases]
    doc = obs.chrome_trace_doc(tracer, driver=driver)
    return seq, timer.report(driver=driver), doc, ops, out


@functools.cache
def _jax_ref(driver, rc):
    seq, ph, doc, ops, out = _traced(el, jobs, driver, jgrid(*rc))
    return seq, ph, doc, ops, np.asarray(el.to_global(out))


@pytest.mark.parametrize("rc", GRIDS, ids=[f"{r}x{c}" for r, c in GRIDS])
@pytest.mark.parametrize("driver", DRIVERS)
def test_traced_driver_equals_jax(driver, rc):
    jseq, jph, jdoc, jops, jout = _jax_ref(driver, rc)
    seq, ph, doc, ops, out = _traced(et, tobs, driver, tgrid(*rc))
    assert seq and seq == jseq
    if driver in ("cholesky", "lu", "qr"):
        assert ph == jph
        assert ph["steps"] and ph["total_seconds"] > 0
    else:
        assert ph["steps"] == []            # no explicit timer handed in
    assert doc == jdoc
    assert ops == jops == {(("op", driver),): 1}
    np.testing.assert_allclose(et.to_global(out).numpy(), jout, rtol=0,
                               atol=1e-10 * max(np.abs(jout).max(), 1))


@pytest.mark.parametrize("driver", ["cholesky", "lu", "qr"])
def test_timer_alone_records_every_phase(driver):
    """Without a tracer the explicit timer is the hook itself."""
    t = tobs.PhaseTimer()
    out = _call(et, driver, tgrid(2, 2), t)
    assert et.to_global(out).shape == (N, N)
    rep = t.report(driver=driver)
    assert [s["step"] for s in rep["steps"]] == \
        ([0] if driver in ("cholesky", "lu") else [0, 1])
    assert rep["total_seconds"] > 0 and rep["schema"] == "phase_timings/v1"


@functools.cache
def _jax_solve_phases(op, rc):
    _, S, B = _inputs()
    jA = el.from_global(S, el.MC, el.MR, jgrid(*rc))
    jB = el.from_global(B[:, :4], el.MC, el.MR, jgrid(*rc))
    tracer = jobs.Tracer(metrics=False, clock=StepClock())
    with jobs.metrics_scope():
        with tracer:
            getattr(el, op)(jA, jB, nb=NB)
    return [(r.driver, r.phase, r.step) for r in tracer.phases]


@pytest.mark.parametrize("op", ["hpd_solve", "lu_solve", "least_squares"])
def test_solve_wrappers_trace_their_drivers(op):
    """The flagships' solve wrappers: the factor's and the sweeps' ticks
    land on the active tracer in the JAX package's order."""
    _, S, B = _inputs()
    tA = et.from_global(S, et.MC, et.MR, tgrid(1, 1))
    tB = et.from_global(B[:, :4], et.MC, et.MR, tgrid(1, 1))
    tracer = tobs.Tracer(metrics=False, clock=StepClock())
    with tobs.metrics_scope():
        with tracer:
            getattr(et, op)(tA, tB, nb=NB)
    seq = [(r.driver, r.phase, r.step) for r in tracer.phases]
    assert seq == _jax_solve_phases(op, (1, 1))
    assert {d for d, _, _ in seq} >= {{"hpd_solve": "cholesky",
                                       "lu_solve": "lu",
                                       "least_squares": "qr"}[op]}


@pytest.mark.parametrize("driver", ["cholesky", "lu", "qr"])
def test_guarded_driver_takes_a_timer(driver):
    """``timer=`` on the checksum-guarded twins: one tick stream per
    guarded step, and the factor equals the untimed guarded run."""
    G, S, _ = _inputs()
    tA = et.from_global(S if driver == "cholesky" else G, et.MC, et.MR,
                        tgrid(2, 2))
    fn = getattr(et, driver)
    plain = fn(tA, nb=NB, abft=True)
    t = tobs.PhaseTimer()
    timed = fn(tA, nb=NB, abft=True, timer=t)
    first = (lambda x: x[0]) if driver != "cholesky" else (lambda x: x)
    assert torch.equal(first(timed).local, first(plain).local)
    steps = {s["step"] for s in t.report()["steps"]}
    assert steps == set(range(N // NB))


def _small(case):
    rng = np.random.default_rng(78)
    F = rng.normal(size=(8, 8))
    if case == "hpd":
        return F @ F.T / 8 + 8 * np.eye(8)
    F[2, 5] = np.nan
    return F


def _resilience_trace(pkg, obs, res, grid, case):
    """``case='hpd'``: guarded cholesky with a one-shot NaN at step 1;
    ``case='nan'``: lu with health=True on a NaN input."""
    A = pkg.from_global(_small(case), pkg.MC, pkg.MR, grid=grid)
    tracer = obs.Tracer(metrics=False, clock=StepClock())
    with obs.metrics_scope():
        with tracer:
            if case == "hpd":
                plan = res.FaultPlan(seed=7, faults=[
                    res.FaultSpec("compute", "nan", nelem=2, window=(1, 2))])
                with res.fault_injection(plan):
                    pkg.cholesky(A, nb=4, abft=True)
            else:
                pkg.lu(A, nb=4, health=True)
    return ([(s.name, s.attrs) for s in tracer.spans],
            [(r.driver, r.phase, r.step) for r in tracer.phases],
            obs.chrome_trace_doc(tracer))


@functools.cache
def _jax_resilience_trace(case):
    from elemental_tpu import resilience as jres
    return _resilience_trace(el, jobs, jres, jgrid(1, 1), case)


def test_recovery_span_equals_jax():
    """A one-shot fault at step 1 under an active tracer: exactly one
    ``abft:recover`` span (step 1, attempt 1), and the span, phase and
    Chrome-trace records of the JAX package."""
    from elemental_tpu_torch import resilience as tres
    spans, seq, doc = _resilience_trace(et, tobs, tres, tgrid(1, 1), "hpd")
    rec = [s for s in spans if s[0] == "abft:recover"]
    assert len(rec) == 1
    assert rec[0][1]["step"] == 1 and rec[0][1]["attempt"] == 1
    assert rec[0][1]["violated"]
    jspans, jseq, jdoc = _jax_resilience_trace("hpd")
    assert spans == jspans and seq == jseq and doc == jdoc


def test_health_instants_equal_jax():
    """``health=True`` on a NaN input under an active tracer: the
    ``health:<kind>`` instants land on the ``events`` track, and the
    Chrome trace equals the JAX package's (values may differ: the JAX
    monitor's cross-device max drops a NaN)."""
    from elemental_tpu_torch import resilience as tres
    _, seq, doc = _resilience_trace(et, tobs, tres, tgrid(1, 1), "nan")
    evs = [ev for ev in doc["traceEvents"]
           if ev.get("ph") == "i" and ev["name"].startswith("health:")]
    assert evs
    lanes = {ev["tid"]: ev["args"]["name"] for ev in doc["traceEvents"]
             if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
    assert lanes[evs[0]["tid"]] == "events"
    _, jseq, jdoc = _jax_resilience_trace("nan")
    assert seq == jseq

    def strip(d):
        return [{k: (v if k != "args" else
                     {a: b for a, b in v.items() if a != "value"})
                 for k, v in ev.items()} for ev in d["traceEvents"]]

    assert strip(doc) == strip(jdoc)
