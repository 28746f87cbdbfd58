"""The port's memory plans and memory lint against the JAX package.

The port measures a driver's peak with the allocator's events (no
jaxpr); what it shares with the JAX package's liveness walk is held
equal to the JAX package's live ``trace_memory`` document on 1x1 and
2x2 grids (memoized once per module): the replicated census, the
input / output residency, ``static`` and ``nonstatic_peak_bytes``.  The
measured peak is deterministic across two runs.  The memory lint's
findings over the registered set are pinned (and listed in ROADMAP.md);
the seeded regressions of ``tests/analysis/test_mem_lint.py`` fire the
same rules; EL007 is the port's shared-memory check of ``lu_panel``."""
import functools

import jax
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu import analysis as jan
from elemental_tpu_torch import analysis as an
from elemental_tpu_torch.analysis.lint import (rule_double_materialization,
                                               rule_mem_budget,
                                               rule_missing_donation,
                                               rule_smem_spill)
from elemental_tpu_torch.analysis.memory import SROW
from elemental_tpu_torch.redist.engine import redistribute

GRIDS = [(1, 1), (2, 2)]
NAMES = an.driver_names()
MC, MR, STAR = et.MC, et.MR, et.STAR

#: what ``mem-lint --all`` reports on the registered set (ROADMAP.md
#: section 2): the guarded drivers' functional panel writes and lq's
#: entry transpose, each a little over the 4x default budget on 2x2
EXPECTED_FINDINGS = {
    ("EL006", "lu_abft", (2, 2)),
    ("EL006", "qr_abft", (2, 2)),
    ("EL006", "qr_lq", (2, 2)),
}


@functools.cache
def _jax_doc(name, rc):
    grid = el.Grid(jax.devices()[: rc[0] * rc[1]], height=rc[0])
    return jan.trace_memory(name, grid)[0].to_doc()


def _grid(rc):
    return et.Grid(*rc, device="cpu")


@functools.cache
def _port(name, rc):
    return an.trace_memory(name, _grid(rc))


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_memory_plan_shares_the_jax_fields(name, rc):
    want = _jax_doc(name, rc)
    got = _port(name, rc)[0].to_doc()
    for key in ("replicated", "args_bytes", "outs_bytes", "static",
                "nonstatic_peak_bytes"):
        assert got[key] == want[key], key
    assert got["static"] is True and got["nonstatic_peak_bytes"] == 0
    assert an.diff_mem_docs(want, got, measured=False) == []
    again = an.trace_memory(name, _grid(rc))[0].to_doc()
    assert again == got                     # the measured peak is stable
    assert got["peak_bytes"] >= got["args_bytes"]
    assert got["peak_path"].startswith(name)


def test_registered_mem_lint_findings_are_pinned():
    found = set()
    for name in NAMES:
        for rc in GRIDS:
            mplan = _port(name, rc)[0]
            records = an.trace_driver(name, _grid(rc))[1]
            for f in an.lint_memory(mplan, records):
                found.add((f.rule, name, rc))
    assert found == EXPECTED_FINDINGS


def test_declared_factors_are_sufficient():
    """Every MEM_BUDGET_FACTORS override holds its driver on both grids
    (the port's peaks are measured, so whether each is load-bearing is
    not pinned)."""
    for name, factor in an.MEM_BUDGET_FACTORS.items():
        for rc in GRIDS:
            assert rule_mem_budget(_port(name, rc)[0], factor) == [], name


# ---------------------------------------------------------------------
# the meter
# ---------------------------------------------------------------------

def test_meter_sees_every_allocation_and_free():
    """Two 4 KiB temporaries, one freed before an 8 KiB result is made
    and the other after: the peak above the inputs is 12 KiB, per device
    a quarter on 2x2."""
    A = et.from_global(torch.ones(32, 32), MC, MR, _grid((2, 2)))

    def fn(a):
        x = torch.empty(1024)
        y = torch.empty(1024)
        del x
        out = torch.empty(2048)
        del y
        return out
    stats, out = an.measure_call(fn, (A,), (2, 2), "toy")
    assert stats.total_peak_bytes == 12288
    assert stats.args_bytes == 32 * 32 * 4 // 4
    assert stats.peak_bytes == stats.args_bytes + 12288 // 4
    assert stats.outs_bytes == 8192 // 4
    assert stats.peak_path == ("toy",) and stats.peak_prim == "aten::empty"


def test_peak_names_the_driver_phase():
    mplan = _port("lu_classic", (2, 2))[0]
    phase = mplan.stats.peak_path[-1]
    assert phase.split("[")[0] in et.obs.phase_timer.PHASES + ("return",)
    assert mplan.stats.peak_prim.startswith("aten::")
    assert mplan.stats.timeline[-1].live_bytes == mplan.stats.peak_bytes


# ---------------------------------------------------------------------
# EL006 peak-over-budget
# ---------------------------------------------------------------------

def test_el006_fires_on_tight_budget():
    mplan = _port("gemm_slice", (2, 2))[0]
    findings = an.lint_memory(mplan, budget_factor=1.0)
    el6 = [f for f in findings if f.rule == "EL006"]
    assert len(el6) == 1
    assert "exceeds the declared budget" in el6[0].message
    assert "MEM_BUDGET_FACTORS" in el6[0].fix_hint
    assert "high-water at" in el6[0].message
    assert mplan.stats.peak_prim in el6[0].message


def test_el006_quiet_at_declared_budget():
    assert an.lint_memory(_port("gemm_slice", (2, 2))[0]) == []


# ---------------------------------------------------------------------
# EL007: lu_panel's slab leaves shared memory
# ---------------------------------------------------------------------

def test_el007_closed_form_on_the_h100_row():
    row = an.SMEM_ROWS["gpu"]
    assert (row.sm_count, row.smem_optin) == (132, 232448)
    for dt, z in (("float32", 4), ("float64", 8)):
        rows = an.spill_rows(dt)
        per_block = (row.smem_optin - row.static_smem[dt]) // (SROW * z)
        assert rows == per_block * 132
        assert an.check_panel_smem("lu", (rows, 64), dt).fits
        assert not an.check_panel_smem("lu", (rows + 1, 64), dt).fits
    assert 117_000 <= an.spill_rows("float32") <= 118_000
    assert 58_000 <= an.spill_rows("float64") <= 59_000


def test_el007_fires_on_a_tall_f32_panel():
    chk = an.check_panel_smem("lu", (an.spill_rows("float32") + 1, 64))
    assert chk.spills
    (f,) = rule_smem_spill([chk])
    assert f.rule == "EL007" and str(chk.slab_bytes) in f.message
    # through the memory lint, at a sweep past the threshold
    mplan = _port("lu_classic", (1, 1))[0]
    tall = an.panel_smem_checks("lu", 131072, 1024)
    assert any(c.spills for c in tall)
    assert any(f.rule == "EL007"
               for f in an.lint_memory(mplan, panel_checks=tall))


def test_el007_quiet_on_the_registered_sweeps():
    for op in ("lu", "cholesky", "qr"):
        for chk in an.panel_smem_checks(op, an.DEFAULT_N, an.DEFAULT_NB):
            assert chk.fits
    assert an.panel_smem_checks("qr", 1 << 20, 1024) == []
    with pytest.raises(KeyError):
        an.kernel_smem_bytes("qr", (64, 16), "float32")


# ---------------------------------------------------------------------
# EL008 missing-donation
# ---------------------------------------------------------------------

def _aba_plan(donated):
    """An entry whose output's (shape, dtype) equals both inputs'."""
    a, b = torch.ones(32, 32), torch.ones(32, 32)
    stats, _ = an.measure_call(lambda x, y: x * 2.0 + y, (a, b), (1, 1),
                               "toy_entry")
    meta = {"n": 32, "dtype": "float32"}
    if donated is not None:
        meta["donated"] = donated
    return an.memory_plan("toy_entry", (1, 1), meta, stats)


def test_el008_fires_on_undonated_matching_input():
    findings = rule_missing_donation(_aba_plan(donated=()))
    assert [f.rule for f in findings] == ["EL008", "EL008"]
    assert "input 0" in findings[0].message


def test_el008_quiet_when_donated_or_undeclared():
    assert rule_missing_donation(_aba_plan(donated=(0, 1))) == []
    assert rule_missing_donation(_aba_plan(donated=None)) == []


# ---------------------------------------------------------------------
# EL009 double-materialization
# ---------------------------------------------------------------------

def _mat():
    return et.from_global(torch.ones(16, 16), MC, MR, _grid((2, 2)))


def test_el009_fires_on_repeated_full_gather():
    def fn(A):
        F1 = redistribute(A, STAR, STAR)
        F2 = redistribute(A, STAR, STAR)
        return F1.local + F2.local
    _, log, _ = an.trace_callable(fn, (_mat(),), grid=_grid((2, 2)))
    mplan = an.measure_call(fn, (_mat(),), (2, 2), "toy_double")[0]
    mplan = an.memory_plan("toy_double", (2, 2), {"n": 16}, mplan, log)
    findings = rule_double_materialization(mplan, log)
    assert [f.rule for f in findings] == ["EL009"]
    assert "2 separate [*,*] gathers" in findings[0].message
    assert "hoist" in findings[0].fix_hint


def test_el009_quiet_on_distinct_operands():
    def fn(A, B):
        return (redistribute(A, STAR, STAR).local
                + redistribute(B, STAR, STAR).local)
    _, log, _ = an.trace_callable(fn, (_mat(), _mat()), grid=_grid((2, 2)))
    stats = an.measure_call(fn, (_mat(), _mat()), (2, 2), "toy_two")[0]
    mplan = an.memory_plan("toy_two", (2, 2), {"n": 16}, stats, log)
    assert rule_double_materialization(mplan, log) == []
