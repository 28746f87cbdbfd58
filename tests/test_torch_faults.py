"""Deterministic fault injection in the port (mirroring
``tests/resilience/test_faults.py``), held against the JAX package.

For the same plan over the same run the port's ``FaultPlan.log`` is the
JAX package's: the same events (target, call, output, kind, shape,
dtype, step) and the same flat indices, and -- where the corrupted
payload is data both packages hold bit-equal (the redistribution of an
input) -- the same ``before`` and ``after`` bit for bit
(``logs_identical`` across the packages).  A payload that is computed
(a factored panel) agrees to rounding between the two packages, so
there ``before`` is held to 1e-12 relative in float64.  The corruption
writes into a copy: the payload, which on a 1x1 grid can be a view of
the caller's storage, is never changed.  Each JAX reference is computed
once per module.  The package surface is the JAX package's: the
resilience ``__all__`` and signatures, the obs metrics names and the
``obs_metrics/v1`` document of the same writes."""
import functools

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu import resilience as jres
from elemental_tpu_torch.resilience import (FAULT_KINDS, FAULT_TARGETS,
                                            FaultPlan, FaultSpec,
                                            certified_solve,
                                            fault_injection, logs_identical)

GRIDS = [(1, 1), (2, 2)]


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _dist(g, arr):
    return et.from_global(arr, et.MC, et.MR, g)


def _problem(seed, n, op, nrhs=2):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(n, n))
    A = F @ F.T / n + n * np.eye(n) if op == "hpd" else F + n * np.eye(n)
    return A, rng.normal(size=(n, nrhs))


def _clean_resid(An, Bn, X):
    Xn = et.to_global(X).numpy().astype(np.float64)
    return np.linalg.norm(Bn - An @ Xn) / (
        np.linalg.norm(An) * np.linalg.norm(Xn) + np.linalg.norm(Bn))


def _mat(seed=101, n=16):
    return np.random.default_rng(seed).normal(size=(n, n)) + n * np.eye(n)


#: (driver, spec) of the cross-package log cases: the engine targets at
#: call 0 carry the gathered input; 'compute' a factored panel
LOG_CASES = {
    "redistribute": ("lu", dict(target="redistribute", kind="bitflip",
                                call=0, nelem=3)),
    "redistribute-step1": ("lu", dict(target="redistribute", kind="scale",
                                      nelem=2, window=(1, 2))),
    "panel_spread": ("cholesky", dict(target="panel_spread", kind="scale",
                                      call=0, nelem=2)),
    "compute": ("lu", dict(target="compute", kind="bitflip", call=0,
                           nelem=2)),
    "compute-chol": ("cholesky", dict(target="compute", kind="scale",
                                      call=1, nelem=2)),
}


def _log_run(pkg, R, g, case):
    driver, spec = LOG_CASES[case]
    M = _problem(7, 16, "hpd" if driver == "cholesky" else "lu")[0]
    plan = R.FaultPlan(seed=42, faults=[R.FaultSpec(**spec)])
    with R.fault_injection(plan):
        # guarded: the classic schedule, whose panel gathers and spreads
        # go through the engine on every grid, 1x1 included
        getattr(pkg, driver)(pkg.from_global(M, pkg.MC, pkg.MR, grid=g),
                             nb=8, abft=True)
    return plan


@functools.cache
def _jax_log(rc, case):
    return _log_run(el, jres, jgrid(*rc), case)


LOG_PARITY = [((1, 1), "redistribute"), ((2, 2), "redistribute"),
              ((2, 2), "redistribute-step1"), ((1, 1), "panel_spread"),
              ((1, 1), "compute"), ((2, 2), "compute-chol")]


@pytest.mark.parametrize("rc,case", LOG_PARITY,
                         ids=[f"{r}x{c}-{k}" for (r, c), k in LOG_PARITY])
def test_fault_log_equals_jax(rc, case):
    pj = _jax_log(rc, case)
    pt = _log_run(et, et.resilience, tgrid(*rc), case)
    assert pt.fired() > 0
    assert [(e.target, e.call, e.output, e.kind, e.shape, e.dtype, e.step)
            for e in pt.log] \
        == [(e.target, e.call, e.output, e.kind, tuple(e.shape), e.dtype,
             e.step) for e in pj.log]
    for a, b in zip(pt.log, pj.log):
        np.testing.assert_array_equal(a.indices, b.indices)
    if case.startswith("redistribute"):
        # the first call's payload is the gathered input: bit for bit
        for a, b in zip(pt.log, pj.log):
            if a.call != 0:
                continue
            assert a.before.tobytes() == b.before.tobytes()
            assert a.after.tobytes() == b.after.tobytes()
    for a, b in zip(pt.log, pj.log):
        np.testing.assert_allclose(a.before, b.before, rtol=1e-12)


def test_logs_identical_across_packages():
    """``logs_identical`` itself, on the input gather of a 2x2 lu."""
    pj = _jax_log((2, 2), "redistribute")
    pt = _log_run(et, et.resilience, tgrid(2, 2), "redistribute")
    assert logs_identical(pt, pj)


# ---------------------------------------------------------------------
# plan mechanics
# ---------------------------------------------------------------------

def test_spec_validation():
    with pytest.raises(ValueError):
        FaultSpec("bogus_target", "nan")
    with pytest.raises(ValueError):
        FaultSpec("redistribute", "bogus_kind")
    with pytest.raises(ValueError):
        FaultSpec("redistribute", "nan", call=-1)
    with pytest.raises(TypeError):
        FaultPlan(0, ["not a spec"])


def test_window_validation():
    with pytest.raises(ValueError):
        FaultSpec("redistribute", "nan", window=(2, 1))
    with pytest.raises(ValueError):
        FaultSpec("redistribute", "nan", window=(-1, 3))
    with pytest.raises(ValueError):
        FaultSpec("redistribute", "nan", window=(0,))
    assert FaultSpec("redistribute", "nan", window=(1, 2)).window == (1, 2)


def test_compute_target_registered():
    assert FAULT_TARGETS == ("redistribute", "panel_spread", "compute")
    assert FAULT_KINDS == ("bitflip", "scale", "nan")
    from elemental_tpu_torch.resilience.faults import _KIND_WORD, _TARGET_WORD
    assert _TARGET_WORD == {"redistribute": 1, "panel_spread": 2,
                            "compute": 3}
    assert _KIND_WORD == {"bitflip": 1, "scale": 2, "nan": 3}


def test_injection_scoped_and_counted():
    g = tgrid(2, 2)
    A = _dist(g, _mat())
    plan = FaultPlan(seed=3, faults=[FaultSpec("redistribute", "nan",
                                               call=0, nelem=2)])
    LU0, _ = et.lu(A, nb=8)
    with fault_injection(plan):
        LU1, _ = et.lu(A, nb=8)
    LU2, _ = et.lu(A, nb=8)
    assert plan.fired() == 1
    ev = plan.log[0]
    assert ev.target == "redistribute" and ev.call == 0 and ev.kind == "nan"
    assert ev.indices.size == 2
    assert np.isnan(ev.after).all() and np.isfinite(ev.before).all()
    assert not torch.isfinite(et.to_global(LU1)).all()
    assert torch.isfinite(et.to_global(LU0)).all()
    assert torch.equal(LU0.local, LU2.local)


@pytest.mark.parametrize("kind", ["bitflip", "scale", "nan"])
def test_corruption_kinds_change_payload(kind):
    plan = FaultPlan(seed=11, faults=[FaultSpec("redistribute", kind,
                                                call=1, nelem=3)])
    with fault_injection(plan):
        et.lu(_dist(tgrid(2, 2), _mat(102)), nb=8)
    assert plan.fired() == 1
    ev = plan.log[0]
    assert ev.kind == kind
    assert not np.array_equal(ev.before, ev.after)
    if kind == "nan":
        assert np.isnan(ev.after).all()
    if kind == "scale":
        np.testing.assert_allclose(ev.after, ev.before * 1e12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex128])
def test_corruption_writes_a_copy(dtype):
    """The payload itself is never written: on a 1x1 grid it may be a
    view of the caller's storage, which a rollback re-reads."""
    base = torch.arange(24, dtype=torch.float64).reshape(4, 6).to(dtype)
    view = base[:, 1:5]                  # non-contiguous, like a retag
    keep = base.clone()
    plan = FaultPlan(seed=1, faults=[FaultSpec("compute", "bitflip",
                                               nelem=3)])
    out, = plan.apply("compute", (view,))
    assert torch.equal(base, keep)
    assert out.shape == view.shape
    ev = plan.log[0]
    flat = out.reshape(-1).numpy()
    assert flat[ev.indices].tobytes() == ev.after.tobytes()
    assert view.reshape(-1).numpy()[ev.indices].tobytes() \
        == ev.before.tobytes()
    rest = np.setdiff1d(np.arange(flat.size), ev.indices)
    assert np.array_equal(flat[rest], view.reshape(-1).numpy()[rest])


def test_integer_payloads_pass_through():
    plan = FaultPlan(seed=1, faults=[FaultSpec("compute", "nan")])
    p = torch.arange(5)
    out, = plan.apply("compute", (p,))
    assert out is p and plan.fired() == 0


def test_different_seed_different_payload():
    logs = []
    for seed in (1, 2):
        plan = FaultPlan(seed=seed, faults=[FaultSpec(
            "redistribute", "bitflip", call=0, nelem=4)])
        with fault_injection(plan):
            et.lu(_dist(tgrid(2, 2), _mat(104)), nb=8)
        logs.append(plan)
    ea, eb = logs[0].log[0], logs[1].log[0]
    assert not (np.array_equal(ea.indices, eb.indices)
                and ea.after.tobytes() == eb.after.tobytes())


# ---------------------------------------------------------------------
# determinism: identical seed => bit-identical corrupted payloads AND the
# same ladder outcome across two runs
# ---------------------------------------------------------------------

@pytest.mark.parametrize("target,op", [("redistribute", "lu"),
                                       ("panel_spread", "hpd")])
def test_fault_determinism_two_runs(target, op):
    An, Bn = _problem(103, 24, op)
    g = tgrid(2, 2)
    A, B = _dist(g, An), _dist(g, Bn)

    def run(plan):
        with fault_injection(plan):
            return certified_solve(op, A, B, nb=8)

    mk = lambda: FaultPlan(seed=42, faults=[
        FaultSpec(target, "scale", call=0),
        FaultSpec(target, "bitflip", call=2, nelem=2)])
    p1, p2 = mk(), mk()
    X1, i1 = run(p1)
    X2, i2 = run(p2)
    assert p1.fired() > 0 and logs_identical(p1, p2)
    assert i1["rung"] == i2["rung"]
    assert [(a["rung"], a["refine_iters"]) for a in i1["attempts"]] \
        == [(a["rung"], a["refine_iters"]) for a in i2["attempts"]]
    if X1 is not None:
        assert torch.equal(X1.local, X2.local)
    p1.reset()
    _, i3 = run(p1)
    assert logs_identical(p1, p2) and i3["rung"] == i1["rung"]


# ---------------------------------------------------------------------
# the 'compute' target: local panel outputs
# ---------------------------------------------------------------------

@pytest.mark.parametrize("driver", ["lu", "cholesky", "qr"])
@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_compute_fault_corrupts_local_panel(rc, driver):
    n = 16
    arr = _mat(120, n)
    if driver == "cholesky":
        arr = arr @ arr.T / n + n * np.eye(n)
    g = tgrid(*rc)

    def run():
        out = getattr(et, driver)(_dist(g, arr), nb=8)
        return (out[0] if isinstance(out, tuple) else out).local.clone()

    clean = run()
    plan = FaultPlan(seed=9, faults=[FaultSpec("compute", "nan", call=0,
                                               nelem=2)])
    with fault_injection(plan):
        dirty = run()
    after = run()
    if driver == "lu" and rc == (1, 1):
        # the 1x1 lu runs the sequential schedule, which has no compute
        # seam in either package
        assert plan.fired() == 0
        return
    assert plan.fired() >= 1
    assert all(ev.target == "compute" for ev in plan.log)
    assert not torch.equal(clean, dirty)
    assert torch.equal(clean, after)


def test_compute_fault_replay_bit_identical():
    def run(plan):
        with fault_injection(plan):
            LU, _ = et.lu(_dist(tgrid(2, 2), _mat(121)), nb=8, crossover=0)
        return LU.local

    mk = lambda: FaultPlan(seed=77, faults=[
        FaultSpec("compute", "bitflip", call=0, every=True, nelem=2)])
    p1, p2 = mk(), mk()
    d1, d2 = run(p1), run(p2)
    assert p1.fired() >= 2
    assert logs_identical(p1, p2)
    assert torch.equal(d1, d2)


def test_compute_vs_redistribute_streams_differ():
    logs = {}
    for target in ("compute", "redistribute"):
        plan = FaultPlan(seed=55, faults=[FaultSpec(target, "bitflip",
                                                    call=0, nelem=3)])
        with fault_injection(plan):
            et.lu(_dist(tgrid(2, 2), _mat(122)), nb=8)
        assert plan.fired() == 1
        logs[target] = plan.log[0]
    ea, eb = logs["compute"], logs["redistribute"]
    assert not (ea.shape == eb.shape
                and np.array_equal(ea.indices, eb.indices)
                and ea.after.tobytes() == eb.after.tobytes())


@pytest.mark.parametrize("mode", ["oneshot", "persistent"])
def test_compute_fault_matrix_certified_or_surfaced(mode):
    An, Bn = _problem(123, 24, "lu")
    g = tgrid(2, 2)
    plan = FaultPlan(seed=13, faults=[FaultSpec(
        "compute", "nan", call=0, every=(mode == "persistent"), nelem=2)])
    with fault_injection(plan):
        X, info = certified_solve("lu", _dist(g, An), _dist(g, Bn), nb=8)
    assert plan.fired() > 0
    if info["certified"]:
        assert _clean_resid(An, Bn, X) <= info["tol"]
    else:
        assert info["failing_phase"] is not None


def test_persistent_corruption_surfaced_with_phase():
    An, Bn = _problem(107, 24, "lu")
    g = tgrid(2, 2)
    plan = FaultPlan(seed=5, faults=[FaultSpec("redistribute", "nan",
                                               call=1, every=True)])
    with fault_injection(plan):
        X, info = certified_solve("lu", _dist(g, An), _dist(g, Bn), nb=8)
    assert info["certified"] is False
    assert info["failing_phase"] is not None
    assert info["health"] is not None
    assert [a["rung"] for a in info["attempts"]] \
        == ["quant", "fast", "refine", "abft", "fp32", "classic"]


# ---------------------------------------------------------------------
# step-scoped (windowed) rules
# ---------------------------------------------------------------------

@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_window_scopes_to_announced_steps(rc):
    arr = _mat(124).astype(np.float32)
    g = tgrid(*rc)
    plan = FaultPlan(seed=7, faults=[
        FaultSpec("redistribute", "nan", nelem=2, window=(1, 2))])
    with fault_injection(plan):
        et.lu(_dist(g, arr), nb=4)
    assert plan.fired() == 0
    plan = FaultPlan(seed=7, faults=[
        FaultSpec("redistribute", "nan", nelem=2, window=(1, 2))])
    with fault_injection(plan):
        et.lu(_dist(g, arr), nb=4, abft=True)
    assert plan.fired() == 1
    assert all(e.step == 1 for e in plan.log)
    plan = FaultPlan(seed=7, faults=[
        FaultSpec("redistribute", "nan", nelem=2, window=(99, 100))])
    with fault_injection(plan):
        et.lu(_dist(g, arr), nb=4, abft=True)
    assert plan.fired() == 0


def test_windowed_plan_replay_bit_identical():
    arr = _mat(125).astype(np.float32)

    def run(plan):
        with fault_injection(plan):
            LU, _ = et.lu(_dist(tgrid(2, 2), arr), nb=4, abft=True)
        return LU.local

    mk = lambda: FaultPlan(seed=77, faults=[
        FaultSpec("compute", "bitflip", nelem=2, window=(1, 3))])
    p1, p2 = mk(), mk()
    d1, d2 = run(p1), run(p2)
    assert p1.fired() == 1
    assert logs_identical(p1, p2)
    assert torch.equal(d1, d2)


# ---------------------------------------------------------------------
# the package surface: the JAX package's names and signatures
# ---------------------------------------------------------------------

def test_resilience_and_obs_export_the_jax_names():
    import elemental_tpu.obs as jobs
    import elemental_tpu_torch.obs as tobs
    assert sorted(et.resilience.__all__) == sorted(jres.__all__)
    for name in ("METRICS_SCHEMA", "HIST_FAMILIES", "MetricsRegistry",
                 "REGISTRY", "current_metrics", "metrics_scope",
                 "hist_family", "inc", "observe", "set_gauge",
                 "set_hist_family", "active_tracer", "NULL_HOOK"):
        assert hasattr(tobs, name) and hasattr(jobs, name), name
    from elemental_tpu.tune import knobs as jk
    from elemental_tpu_torch.tune import knobs as tk
    assert (tk.COMM_PRECISIONS, tk.LU_PANELS) \
        == (jk.COMM_PRECISIONS, jk.LU_PANELS)


@pytest.mark.parametrize("name", sorted(
    n for n in jres.__all__ if callable(getattr(jres, n))))
def test_resilience_signatures_equal_jax(name):
    import inspect
    jf, tf = getattr(jres, name), getattr(et.resilience, name)
    if inspect.isclass(jf):
        jf, tf = jf.__init__, tf.__init__
    assert list(inspect.signature(tf).parameters) \
        == list(inspect.signature(jf).parameters)


def test_metrics_registry_doc_equals_jax():
    """The same writes give the same ``obs_metrics/v1`` document."""
    from elemental_tpu.obs import metrics as jm
    from elemental_tpu_torch.obs import metrics as tm

    def writes(m):
        with m.scoped() as reg:
            m.inc("abft_checks", 9, driver="lu")
            m.inc("abft_checks", driver="lu")
            m.set_gauge("depth", 3.5, grid="2x2")
            for v in (2e-6, 3e-3, 0.5, 250.0):
                m.observe("phase_seconds", v, phase="panel")
            m.observe("wire_bytes", 5000, route="chain")
            m.observe("retry_count", 3)
            return reg.to_doc(run="x"), reg.counter_value(
                "abft_checks", driver="lu")

    assert writes(tm) == writes(jm)
