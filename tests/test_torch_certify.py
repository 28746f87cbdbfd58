"""Certified solves in the port (mirroring
``tests/resilience/test_certify.py``), held against the JAX package.

``solve_certificate/v1`` equals the JAX package's field by field (the
health reports' floats to 1e-12 relative in float64, the residuals --
backward errors at ~1e-16 -- to 16 eps absolute; every JAX reference
computed once per module) for a clean solve on 1x1 and 2x2 grids and for the
compute-target escalation on a 1x1 grid: NaNs in the first diagonal
block of the first two factorizations make 'quant', 'fast' and
'refine' fail and 'abft' certify.  The JAX test's own assertions then
run on the port alone, and ``lu_solve`` / ``hpd_solve`` give their
``info=True`` singularity signal."""
import functools

import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu import resilience as jres
from elemental_tpu_torch.resilience import (CERT_SCHEMA, LADDER_NAMES, Rung,
                                            FaultPlan, FaultSpec,
                                            certified_solve, default_ladder,
                                            default_tol, fault_injection)

GRIDS = [(1, 1), (2, 2)]


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _problem(seed, n, nrhs=3, op="lu"):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(n, n))
    A = F @ F.T / n + n * np.eye(n) if op == "hpd" else F + n * np.eye(n)
    return A, rng.normal(size=(n, nrhs))


def _clean_resid(An, Bn, X):
    Xn = et.to_global(X).numpy().astype(np.float64)
    return np.linalg.norm(Bn - An @ Xn) / (
        np.linalg.norm(An) * np.linalg.norm(Xn) + np.linalg.norm(Bn))


def _solve(pkg, rc, op, An, Bn, plan=None, **kw):
    g = jgrid(*rc) if pkg is el else tgrid(*rc)
    R = jres if pkg is el else et.resilience
    A = pkg.from_global(An, pkg.MC, pkg.MR, grid=g)
    B = pkg.from_global(Bn, pkg.MC, pkg.MR, grid=g)
    if plan is None:
        return R.certified_solve(op, A, B, **kw)
    with R.fault_injection(plan):
        return R.certified_solve(op, A, B, **kw)


def _compute_plan(R, second: int):
    """One-shot NaNs on the 'compute' target at call 0 and at the first
    call of the second factorization."""
    return R.FaultPlan(seed=5, faults=[
        R.FaultSpec("compute", "nan", call=0),
        R.FaultSpec("compute", "nan", call=second)])


#: _potrf_inv calls of one 1x1 cholesky at n = 24, nb = 8
_CHOL_CALLS = 3


@functools.cache
def _jax_cert(rc, op, case):
    if case == "clean":
        An, Bn = _problem(91, 24, op=op)
        return _solve(el, rc, op, An, Bn, nb=8)[1]
    An, Bn = _problem(106, 24, op="hpd")
    return _solve(el, rc, "hpd", An, Bn, _compute_plan(jres, _CHOL_CALLS),
                  nb=8)[1]


def _same_health(ht, hj):
    if hj is None:
        assert ht is None
        return
    assert {k: v for k, v in ht.items()
            if k not in ("growth_estimate", "scale", "min_diag", "flags")} \
        == {k: v for k, v in hj.items()
            if k not in ("growth_estimate", "scale", "min_diag", "flags")}
    for key in ("growth_estimate", "scale", "min_diag"):
        assert ht[key] == pytest.approx(hj[key], rel=1e-12, abs=0)
    assert [(f["kind"], f["phase"], f["step"]) for f in ht["flags"]] \
        == [(f["kind"], f["phase"], f["step"]) for f in hj["flags"]]


#: a certificate's residual is a backward error: at ~eps it is rounding
#: noise of its own float64 solve, so the port's and the JAX package's
#: agree to a few eps, not to a relative tolerance
_RESID_ATOL = 16 * np.finfo(np.float64).eps


def _same_cert(ct, cj, rtol=1e-12):
    assert set(ct) == set(cj)
    for key in ("schema", "op", "certified", "rung", "refine_iters",
                "ladder", "singular", "timed_out", "failing_phase"):
        assert ct[key] == cj[key], key
    assert ct["tol"] == pytest.approx(cj["tol"], rel=rtol, abs=0)
    assert abs(ct["residual"] - cj["residual"]) <= _RESID_ATOL
    assert len(ct["attempts"]) == len(cj["attempts"])
    for at, aj in zip(ct["attempts"], cj["attempts"]):
        for key in ("rung", "refine_iters", "singular", "diag_index"):
            assert at[key] == aj[key], key
        if aj["residual"] is None:
            assert at["residual"] is None
        else:
            assert abs(at["residual"] - aj["residual"]) <= _RESID_ATOL
        _same_health(at["health"], aj["health"])
    _same_health(ct["health"], cj["health"])


# ---------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------

@pytest.mark.parametrize("rc,op", [((2, 2), "lu"), ((1, 1), "hpd")],
                         ids=["2x2-lu", "1x1-hpd"])
def test_clean_certificate_equals_jax(rc, op):
    """Both certify at 'quant' with the same refinement count, and their
    residuals agree to ``_RESID_ATOL``."""
    An, Bn = _problem(91, 24, op=op)
    X, ct = _solve(et, rc, op, An, Bn, nb=8)
    _same_cert(ct, _jax_cert(rc, op, "clean"))
    assert ct["certified"] is True and ct["rung"] == "quant"
    assert _clean_resid(An, Bn, X) <= ct["tol"]


def test_compute_escalation_order_equals_jax():
    """The compute-target image of the JAX pin
    ``test_oneshot_fault_escalation_order_pinned`` (a 1x1 grid has no
    panel_spread): NaNs in the first diagonal block of the 'quant' and
    'fast' factorizations; 'refine' shares fast's factor; 'abft'
    refactors under the guarded schedule with the one-shots spent."""
    An, Bn = _problem(106, 24, op="hpd")
    plan = _compute_plan(et.resilience, _CHOL_CALLS)
    X, ct = _solve(et, (1, 1), "hpd", An, Bn, plan, nb=8)
    # both outputs of each corrupted call, (L, L^-1), take a NaN
    assert [e.call for e in plan.log] == [0, 0, _CHOL_CALLS, _CHOL_CALLS]
    assert ct["certified"] is True and ct["rung"] == "abft"
    assert [a["rung"] for a in ct["attempts"]] == ["quant", "fast",
                                                   "refine", "abft"]
    assert ct["attempts"][0]["health"]["ok"] is False
    assert ct["attempts"][1]["health"]["ok"] is False
    assert _clean_resid(An, Bn, X) <= ct["tol"]
    _same_cert(ct, _jax_cert((1, 1), "hpd", "escalation"))


def test_potrf_calls_per_factorization():
    """The second factorization's first diagonal block is call
    ``_CHOL_CALLS`` of the compute target."""
    An, _ = _problem(106, 24, op="hpd")
    plan = FaultPlan(seed=5, faults=[])
    with fault_injection(plan):
        et.cholesky(et.from_global(An, et.MC, et.MR, tgrid(1, 1)), nb=8)
    assert plan.calls["compute"] == _CHOL_CALLS


# ---------------------------------------------------------------------
# the JAX test's assertions on the port
# ---------------------------------------------------------------------

def test_ladder_order_pinned():
    assert LADDER_NAMES == ("quant", "fast", "refine", "abft", "fp32",
                            "classic")
    for op in ("lu", "hpd"):
        rungs = default_ladder(op)
        assert tuple(r.name for r in rungs) == LADDER_NAMES
        assert [r.refactor for r in rungs] == [True, True, False, True,
                                               True, True]
        assert [r.refine for r in rungs] == [8, 2, 8, 4, 4, 4]
        ab = rungs[3]
        assert ab.config.get("abft") is True
        assert "comm_precision" not in ab.config
        q, f = rungs[0], rungs[1]
        assert q.config["comm_precision"] == "int8"
        assert {k: v for k, v in q.config.items()
                if k != "comm_precision"} == f.config
    from elemental_tpu_torch.tune.knobs import LU_PANELS
    lu_rungs = default_ladder("lu")
    assert lu_rungs[0].config["panel"] == LU_PANELS[1]
    assert lu_rungs[-1].config["panel"] == LU_PANELS[0]
    with pytest.raises(ValueError):
        default_ladder("qr")


def test_certificate_schema_pin():
    An, Bn = _problem(93, 16)
    _, info = _solve(et, (2, 2), "lu", An, Bn, nb=8)
    assert info["schema"] == CERT_SCHEMA
    assert set(info) == {"schema", "op", "certified", "rung", "residual",
                         "tol", "refine_iters", "ladder", "attempts",
                         "singular", "timed_out", "failing_phase", "health"}
    assert info["timed_out"] is False
    assert info["ladder"] == list(LADDER_NAMES)
    att = info["attempts"][0]
    assert set(att) == {"rung", "residual", "refine_iters", "singular",
                        "diag_index", "health"}
    assert att["health"]["schema"] == "health_report/v1"
    assert info["tol"] == pytest.approx(default_tol(16, np.float64))


def test_impossible_tol_exhausts_ladder():
    An, Bn = _problem(94, 16)
    X, info = _solve(et, (2, 2), "lu", An, Bn, nb=8, tol=0.0)
    assert info["certified"] is False and info["rung"] is None
    assert [a["rung"] for a in info["attempts"]] == list(LADDER_NAMES)
    assert info["failing_phase"] == "residual"
    assert info["singular"] is False
    assert _clean_resid(An, Bn, X) < 1e-12


def test_singular_input_structured_failure():
    rng = np.random.default_rng(95)
    F = rng.normal(size=(16, 16))
    F[11] = F[4]
    B = rng.normal(size=(16, 2))
    X, info = _solve(et, (2, 2), "lu", F, B, nb=8)
    assert info["certified"] is False
    assert info["singular"] is True
    assert info["failing_phase"] in ("diag", "panel")
    atts = info["attempts"]
    assert [a["rung"] for a in atts] == list(info["ladder"])
    full_wire = [a for a in atts if a["rung"] != "quant"]
    assert all(a["singular"] for a in full_wire)
    assert all(a["diag_index"] is not None for a in full_wire)
    assert X is None


def test_custom_ladder_and_tol():
    An, Bn = _problem(96, 16)
    ladder = (Rung("classic", {"panel": "classic",
                               "update_precision": None}, refine=2),)
    X, info = _solve(et, (2, 2), "lu", An, Bn, nb=8, ladder=ladder,
                     tol=1e-10)
    assert info["certified"] is True and info["rung"] == "classic"
    assert info["ladder"] == ["classic"] and info["tol"] == 1e-10


@pytest.mark.parametrize("kind", ["bitflip", "scale", "nan"])
@pytest.mark.parametrize("target", ["redistribute", "panel_spread",
                                    "compute"])
def test_fault_matrix_no_silent_garbage(target, kind):
    """Every corruption class on every target: certified (and then truly
    within tolerance) or a structured failure naming its phase."""
    op = "hpd" if target == "panel_spread" else "lu"
    An, Bn = _problem(105, 24, op=op)
    plan = FaultPlan(seed=13, faults=[FaultSpec(
        target, kind, call=2 if target == "redistribute" else 0,
        every=True, nelem=2)])
    X, info = _solve(et, (2, 2), op, An, Bn, plan, nb=8)
    assert plan.fired() > 0
    if info["certified"]:
        assert np.isfinite(et.to_global(X).numpy()).all()
        assert _clean_resid(An, Bn, X) <= info["tol"]
    else:
        assert info["failing_phase"] is not None and info["attempts"]


def test_oneshot_panel_spread_escalation_order_pinned():
    An, Bn = _problem(106, 24, op="hpd")
    plan = FaultPlan(seed=5, faults=[FaultSpec("panel_spread", "nan",
                                               call=0),
                                     FaultSpec("panel_spread", "nan",
                                               call=1)])
    X, info = _solve(et, (2, 2), "hpd", An, Bn, plan, nb=8)
    assert info["certified"] is True and info["rung"] == "abft"
    assert [a["rung"] for a in info["attempts"]] == ["quant", "fast",
                                                     "refine", "abft"]
    assert _clean_resid(An, Bn, X) <= info["tol"]
    assert info["attempts"][0]["health"]["ok"] is False
    assert info["attempts"][1]["health"]["ok"] is False


# ---------------------------------------------------------------------
# the structured singular signal on the plain solve drivers
# ---------------------------------------------------------------------

@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_lu_solve_info_singular_pinned(rc):
    rng = np.random.default_rng(97)
    F = rng.normal(size=(16, 16))
    F[9] = F[2]
    Bn = rng.normal(size=(16, 2))
    g = tgrid(*rc)
    B = et.from_global(Bn, et.MC, et.MR, g)
    X, inf = et.lu_solve(et.from_global(F, et.MC, et.MR, g), B, nb=8,
                         info=True)
    assert inf["singular"] is True and inf["diag_index"] == 15
    assert inf["finite"] is True
    F2 = rng.normal(size=(16, 16)) + 16 * np.eye(16)
    X2, inf2 = et.lu_solve(et.from_global(F2, et.MC, et.MR, g), B, nb=8,
                           info=True)
    assert inf2 == {"singular": False, "diag_index": None, "finite": True}
    assert np.isfinite(et.to_global(X2).numpy()).all()


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_hpd_solve_info_singular(rc):
    rng = np.random.default_rng(98)
    v = rng.normal(size=(16, 2))
    g = tgrid(*rc)
    B = et.from_global(rng.normal(size=(16, 2)), et.MC, et.MR, g)
    X, inf = et.hpd_solve(et.from_global(v @ v.T, et.MC, et.MR, g), B,
                          nb=8, info=True)
    assert inf["singular"] is True and inf["diag_index"] is not None
    X2, inf2 = et.hpd_solve(
        et.from_global(v @ v.T + 16 * np.eye(16), et.MC, et.MR, g), B,
        nb=8, info=True, health=True)
    assert inf2["singular"] is False and inf2["finite"] is True
    assert et.resilience.last_health_report("cholesky")["ok"] is True


def test_solve_info_default_unchanged():
    An, Bn = _problem(99, 16)
    g = tgrid(2, 2)
    X = et.lu_solve(et.from_global(An, et.MC, et.MR, g),
                    et.from_global(Bn, et.MC, et.MR, g), nb=8)
    assert isinstance(X, et.DistMatrix)


# ---------------------------------------------------------------------
# deadline-bounded certification
# ---------------------------------------------------------------------

class _Deadline:
    """A budget on a manual clock: ``remaining()`` costs ``tick``."""

    def __init__(self, budget, tick=0.0, t0=0.0):
        self.budget, self.tick, self.t = budget, tick, t0

    def remaining(self):
        self.t += self.tick
        return self.budget - self.t


def test_deadline_pre_expired_no_attempts():
    An, Bn = _problem(110, 16)
    X, info = _solve(et, (2, 2), "lu", An, Bn, nb=8,
                     deadline=_Deadline(1.0, t0=5.0))
    assert info["certified"] is False and info["timed_out"] is True
    assert info["attempts"] == [] and X is None
    assert info["failing_phase"] == "deadline"
    assert info["residual"] is None


def test_deadline_mid_ladder_best_so_far():
    An, Bn = _problem(111, 16)
    X, info = _solve(et, (2, 2), "lu", An, Bn, nb=8, tol=0.0,
                     deadline=_Deadline(1.0, tick=0.3))
    assert info["certified"] is False and info["timed_out"] is True
    assert 0 < len(info["attempts"]) < len(LADDER_NAMES)
    assert info["failing_phase"] == "deadline"
    assert X is not None and _clean_resid(An, Bn, X) < 1e-6
    assert info["residual"] == pytest.approx(
        min(a["residual"] for a in info["attempts"]
            if a["residual"] is not None))


def test_deadline_loose_budget_is_inert():
    An, Bn = _problem(112, 16)
    _, base = _solve(et, (2, 2), "lu", An, Bn, nb=8)
    _, info = _solve(et, (2, 2), "lu", An, Bn, nb=8,
                     deadline=_Deadline(3600.0))
    assert info["certified"] is True and info["timed_out"] is False
    assert info["rung"] == base["rung"]
