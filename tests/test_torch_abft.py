"""ABFT checksum-guarded factorizations in the port (mirroring
``tests/resilience/test_abft.py``), held against the JAX package.

The acceptance matrix {bitflip, scale, nan} x {redistribute, compute}
inside the guarded lu / cholesky / qr (classic and tsqr panels) runs the
JAX test's own assertions on the port alone: detected at the injected
panel, repaired by ONE panel re-execution, and the recovered storage
bit-equal to the clean guarded run (rollback re-executes from an
untouched state).  The guarded outputs are bit-equal to
``lookahead=False`` (lu, cholesky) and to plain ``qr`` on a 2x2 grid,
as in the JAX tests.  ``abft_report/v1`` equals the JAX package's field
by field (violation values to 1e-12 relative in float64); every JAX
reference is computed once per module.  JAX references run on 1x1 and
2x2 grids only (XLA's rendezvous timeout, ROADMAP section 3)."""
import functools

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu import resilience as jres
from elemental_tpu_torch.obs import metrics_scope
from elemental_tpu_torch.resilience import (ABFT_SCHEMA, AbftGuard,
                                            FaultPlan, FaultSpec,
                                            HealthMonitor, fault_injection,
                                            last_abft_report)

GRIDS = [(1, 1), (2, 2)]
DRIVER = {"lu": "lu", "hpd": "cholesky", "qr": "qr", "tsqr": "qr"}


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _build(op, n, dtype=np.float32, seed=0):
    """A well-conditioned host matrix (the JAX test's ``_build``)."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n, n)).astype(dtype)
    return F @ F.T / n + n * np.eye(n, dtype=dtype) if op == "hpd" \
        else F + n * np.eye(n, dtype=dtype)


def _run(pkg, g, op, M, nb=4, **kw):
    """One guarded call of ``op`` in package ``pkg`` (``el`` or ``et``)
    on grid ``g``: returns (storage as numpy, perm/tau as numpy or None,
    the abft report)."""
    A = pkg.from_global(M, pkg.MC, pkg.MR, grid=g)
    if op == "lu":
        F, extra = pkg.lu(A, nb=nb, **kw)
    elif op in ("qr", "tsqr"):
        F, extra = pkg.qr(A, nb=nb, panel="tsqr" if op == "tsqr"
                          else "classic", **kw)
    else:
        F, extra = pkg.cholesky(A, nb=nb, **kw), None
    rep = (jres.last_abft_report if pkg is el else last_abft_report)(
        DRIVER[op]) if kw.get("abft") else None
    return np.asarray(F.local), \
        None if extra is None else np.asarray(extra), rep, F


def _port(rc, op, M, **kw):
    return _run(et, tgrid(*rc), op, M, **kw)


@functools.cache
def _jax_faulted(rc, op, target, kind, dtype):
    """The JAX package's guarded run under the step-1 one-shot fault."""
    M = _build(op, 12, dtype=np.dtype(dtype))
    plan = jres.FaultPlan(seed=7, faults=[
        jres.FaultSpec(target, kind, nelem=2, window=(1, 2))])
    with jres.fault_injection(plan):
        stor, extra, rep, _ = _run(el, jgrid(*rc), op, M, abft=True)
    return stor, extra, rep, plan


@functools.cache
def _port_clean(rc, op):
    """The clean guarded run the recovered ones are held bit-equal to."""
    stor, extra, _, _ = _port(rc, op, _build(op, 12), abft=True)
    return stor, extra


def _lu_residual(M, LU, perm):
    n = M.shape[0]
    L = np.tril(LU, -1) + np.eye(n, dtype=LU.dtype)
    return np.linalg.norm(M[perm] - L @ np.triu(LU)) / np.linalg.norm(M)


def _chol_residual(M, Lg):
    return np.linalg.norm(M - Lg @ Lg.conj().T) / np.linalg.norm(M)


def _qr_residual(M, Ap, tau):
    Q = et.to_global(et.explicit_q(Ap, tau)).numpy()
    R = np.triu(et.to_global(Ap).numpy())
    return np.linalg.norm(M - Q @ R) / np.linalg.norm(M)


def _residual(op, M, F, extra):
    if op == "lu":
        return _lu_residual(M, et.to_global(F).numpy(), extra)
    if op == "hpd":
        return _chol_residual(M, et.to_global(F).numpy())
    return _qr_residual(M, F, torch.as_tensor(extra))


def _same_report(rt, rj, rtol=1e-12):
    """``abft_report/v1`` field by field; violation values to ``rtol``."""
    assert set(rt) == set(rj)
    for key in rj:
        if key != "violations":
            assert rt[key] == rj[key], key
    assert len(rt["violations"]) == len(rj["violations"])
    for vt, vj in zip(rt["violations"], rj["violations"]):
        assert {k: v for k, v in vt.items() if k != "value"} \
            == {k: v for k, v in vj.items() if k != "value"}
        if vj["value"] is None:
            assert vt["value"] is None
        else:
            assert vt["value"] == pytest.approx(vj["value"], rel=rtol,
                                                abs=0)


# ---------------------------------------------------------------------
# clean guarded runs: ok reports equal to JAX's, bitwise-plain output
# ---------------------------------------------------------------------

#: the JAX parity cases: each op on both grids, once clean and once
#: recovered, one kind per fault target
CLEAN_PARITY = [((1, 1), "lu"), ((1, 1), "hpd"), ((2, 2), "qr"),
                ((2, 2), "tsqr")]
FAULT_PARITY = [((2, 2), "lu", "redistribute", "nan"),
                ((2, 2), "hpd", "compute", "scale"),
                ((1, 1), "qr", "redistribute", "nan"),
                ((1, 1), "tsqr", "compute", "scale")]


@pytest.mark.parametrize("rc,op", CLEAN_PARITY,
                         ids=[f"{r}x{c}-{op}" for (r, c), op in CLEAN_PARITY])
def test_clean_report_equals_jax(rc, op):
    M = _build(op, 12, dtype=np.float64)
    _, _, rj, _ = _run(el, jgrid(*rc), op, M, abft=True)
    stor, extra, rt, F = _port(rc, op, M, abft=True)
    assert rt["schema"] == ABFT_SCHEMA and rt["ok"] is True
    assert rt["panels"] == 3 and rt["checks"] > 0
    assert rt["violations"] == [] and rt["recompute_count"] == 0
    assert rt["quantized_wire"] is False
    _same_report(rt, rj)
    assert _residual(op, M, F, extra) < 1e-12


def test_report_schema_pin():
    _port((2, 2), "lu", _build("lu", 16), abft=True)
    rep = last_abft_report("lu")
    assert set(rep) == {"schema", "driver", "ok", "panels", "checks",
                        "violations", "recovered_panels",
                        "unrecovered_panels", "recompute_count",
                        "max_retries", "quantized_wire"}


def test_abft_true_output_bitwise_plain():
    """The guarded path only OBSERVES: abft forces the classic
    right-looking schedule, so on an r x c grid the bitwise reference is
    lookahead=False."""
    M = _build("lu", 16, dtype=np.float64, seed=3)
    g = tgrid(2, 2)
    A = et.from_global(M, et.MC, et.MR, g)
    LU0, p0 = et.lu(A, nb=4, lookahead=False)
    LU1, p1 = et.lu(A, nb=4, abft=True)
    assert torch.equal(LU0.local, LU1.local) and torch.equal(p0, p1)
    S = et.from_global(_build("hpd", 16, dtype=np.float64, seed=3),
                       et.MC, et.MR, g)
    assert torch.equal(et.cholesky(S, nb=4, lookahead=False).local,
                       et.cholesky(S, nb=4, abft=True).local)


def test_qr_abft_output_bitwise_plain():
    M = _build("lu", 16, dtype=np.float64, seed=3)
    A = et.from_global(M, et.MC, et.MR, tgrid(2, 2))
    Ap0, tau0 = et.qr(A, nb=4)
    Ap1, tau1 = et.qr(A, nb=4, abft=True)
    Ap2, tau2 = et.qr(A, nb=4, abft=None)
    assert torch.equal(Ap0.local, Ap1.local) and torch.equal(tau0, tau1)
    assert torch.equal(Ap0.local, Ap2.local)


def test_guarded_call_leaves_its_input_untouched():
    """On a 1x1 grid the panel gathers are retags of views of A; the
    guarded drivers never write into them."""
    for op in ("lu", "hpd", "qr"):
        M = _build(op, 16, dtype=np.float64, seed=4)
        A = et.from_global(M, et.MC, et.MR, tgrid(1, 1))
        before = A.local.clone()
        plan = FaultPlan(seed=3, faults=[
            FaultSpec("redistribute", "nan", nelem=2, window=(0, 1))])
        with fault_injection(plan):
            {"lu": et.lu, "qr": et.qr, "hpd": et.cholesky}[op](
                A, nb=4, abft=True)
        assert plan.fired() == 1
        assert torch.equal(A.local, before)


# ---------------------------------------------------------------------
# THE ACCEPTANCE MATRIX: one-shot {bitflip, scale, nan} x
# {redistribute, compute} inside the guarded drivers -> detected at the
# injected panel, recovered by re-executing ONLY that panel, and the
# recovered storage bit-equal to the clean guarded run
# ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bitflip", "scale", "nan"])
@pytest.mark.parametrize("target", ["redistribute", "compute"])
@pytest.mark.parametrize("op", ["lu", "hpd", "qr", "tsqr"])
@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_acceptance_matrix_panel_recovery(rc, op, target, kind):
    M = _build(op, 12)
    plan = FaultPlan(seed=7, faults=[
        FaultSpec(target, kind, nelem=2, window=(1, 2))])
    with fault_injection(plan):
        stor, extra, rep, F = _port(rc, op, M, abft=True)
    assert plan.fired() >= 1, "fault never landed: the cell is vacuous"
    assert sorted({v["step"] for v in rep["violations"]}) == [1]
    assert rep["recompute_count"] == 1       # ONLY the corrupted panel
    assert rep["recovered_panels"] == [1]
    assert rep["unrecovered_panels"] == []
    assert rep["ok"] is True
    assert _residual(op, M.astype(np.float64), F, extra) < 1e-5
    cstor, cextra = _port_clean(rc, op)
    np.testing.assert_array_equal(stor, cstor)
    if extra is not None:
        np.testing.assert_array_equal(extra, cextra)


@pytest.mark.parametrize("rc,op,target,kind", FAULT_PARITY,
                         ids=[f"{r}x{c}-{op}-{t}-{k}"
                              for (r, c), op, t, k in FAULT_PARITY])
def test_recovery_report_equals_jax(rc, op, target, kind):
    """One kind per target: the recovered run's report is the JAX
    package's, and so is the fault plan's log (indices, call, step)."""
    _, _, rj, pj = _jax_faulted(rc, op, target, kind, "float64")
    M = _build(op, 12, dtype=np.float64)
    plan = FaultPlan(seed=7, faults=[
        FaultSpec(target, kind, nelem=2, window=(1, 2))])
    with fault_injection(plan):
        _, _, rt, _ = _port(rc, op, M, abft=True)
    _same_report(rt, rj)
    assert [(e.target, e.call, e.output, e.kind, e.shape, e.dtype, e.step)
            for e in plan.log] \
        == [(e.target, e.call, e.output, e.kind, tuple(e.shape), e.dtype,
             e.step) for e in pj.log]
    for et_, ej in zip(plan.log, pj.log):
        np.testing.assert_array_equal(et_.indices, ej.indices)
        np.testing.assert_allclose(et_.before, ej.before, rtol=1e-12)


def test_violation_doc_shape():
    plan = FaultPlan(seed=7, faults=[
        FaultSpec("redistribute", "nan", nelem=2, window=(1, 2))])
    with fault_injection(plan):
        _port((2, 2), "lu", _build("lu", 16), abft=True)
    rep = last_abft_report("lu")
    assert rep["violations"]
    for v in rep["violations"]:
        assert set(v) == {"step", "attempt", "phase", "kind", "value",
                          "nonfinite", "columns"}
        assert v["step"] == 1 and v["attempt"] == 0


# ---------------------------------------------------------------------
# quantized wire: the widened threshold absorbs block-scaled rounding
# ---------------------------------------------------------------------

@pytest.mark.parametrize("op", ["lu", "hpd", "qr"])
def test_quantized_wire_no_false_positives(op):
    M = _build(op, 16, dtype=np.float64, seed=9)
    _, _, rep, _ = _port((2, 2), op, M, nb=8, abft=True,
                         comm_precision="bf16")
    assert rep["quantized_wire"] is True
    assert rep["violations"] == [] and rep["ok"] is True


def test_quantized_flag_follows_the_knob_on_1x1():
    """As in the JAX package: the report's ``quantized_wire`` follows the
    knob even on a 1x1 grid, where the wire does nothing."""
    _, _, rep, _ = _port((1, 1), "lu", _build("lu", 16), nb=8, abft=True,
                         comm_precision="int8")
    assert rep["quantized_wire"] is True and rep["ok"] is True


# ---------------------------------------------------------------------
# persistent faults: retries exhaust, the panel commits UNRECOVERED and
# surfaces through the bound health monitor
# ---------------------------------------------------------------------

@pytest.mark.parametrize("op", ["lu", "qr"])
def test_persistent_fault_surfaces_through_health(op):
    mon = HealthMonitor()
    plan = FaultPlan(seed=7, faults=[
        FaultSpec("redistribute", "nan", every=True, nelem=2)])
    with fault_injection(plan):
        _port((2, 2), op, _build(op, 16 if op == "lu" else 12),
              abft=AbftGuard(max_retries=1), health=mon)
    rep = last_abft_report(op)
    assert rep["ok"] is False
    assert rep["unrecovered_panels"]
    assert rep["recompute_count"] >= rep["max_retries"]
    hrep = mon.report()
    assert hrep["ok"] is False
    flags = [f for f in hrep["flags"] if f["kind"] == "abft"]
    assert flags
    assert hrep["failing_phase"] == flags[0]["phase"]


def test_qr_windowed_fault_fires_once_replay_identical():
    from elemental_tpu_torch.resilience import logs_identical
    M = _build("qr", 12, dtype=np.float64, seed=5)

    def run():
        plan = FaultPlan(seed=7, faults=[
            FaultSpec("redistribute", "bitflip", nelem=2, window=(1, 2))])
        with fault_injection(plan):
            stor, tau, _, _ = _port((2, 2), "qr", M, abft=True)
        return plan, stor, tau

    p1, A1, t1 = run()
    p2, A2, t2 = run()
    assert p1.fired() == 1 and p2.fired() == 1
    assert logs_identical(p1, p2)
    np.testing.assert_array_equal(A1, A2)
    np.testing.assert_array_equal(t1, t2)


# ---------------------------------------------------------------------
# observability: the metrics counters
# ---------------------------------------------------------------------

def test_metrics_emitted():
    plan = FaultPlan(seed=7, faults=[
        FaultSpec("compute", "scale", nelem=2, window=(1, 2))])
    with metrics_scope() as reg:
        with fault_injection(plan):
            _port((2, 2), "lu", _build("lu", 16), abft=True)
        rep = last_abft_report("lu")
        assert reg.counter_value("abft_checks", driver="lu") \
            == rep["checks"]
        assert reg.counter_value("abft_violations", driver="lu") \
            == len(rep["violations"])
        assert reg.counter_value("abft_recovered_panels", driver="lu") == 1


def test_explicit_guard_passthrough():
    g = AbftGuard(max_retries=1)
    _port((2, 2), "lu", _build("lu", 16), abft=g)
    rep = g.report()
    assert rep["driver"] == "lu" and rep["max_retries"] == 1
    assert last_abft_report("lu") is rep
    assert last_abft_report() is rep


def test_least_squares_threads_abft():
    rng = np.random.default_rng(6)
    F, b = rng.normal(size=(16, 8)), rng.normal(size=(16, 2))
    g = tgrid(2, 2)
    plan = FaultPlan(seed=7, faults=[
        FaultSpec("compute", "nan", nelem=2, window=(1, 2))])
    with fault_injection(plan):
        X = et.least_squares(et.from_global(F, et.MC, et.MR, g),
                             et.from_global(b, et.MC, et.MR, g), nb=4,
                             abft=True)
    rep = last_abft_report("qr")
    assert rep["recovered_panels"] == [1] and rep["ok"] is True
    np.testing.assert_allclose(et.to_global(X).numpy(),
                               np.linalg.lstsq(F, b, rcond=None)[0],
                               atol=1e-12)

