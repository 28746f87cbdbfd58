"""The port's comm lint (EL001-EL005, EL009) and its audit command line,
against the JAX package.

Over every registered driver on 1x1 and 2x2 the port's findings (rule,
driver) equal the JAX package's ``lint_plan`` of its live trace.  The
seeded regressions of ``tests/analysis/test_lint.py`` are rebuilt on the
port's engine and fire the same rules.  ``python -m
elemental_tpu_torch.analysis`` prints the same per-driver lines and exits
with the same code as ``python -m perf.comm_audit`` for ``diff`` and
``lint`` on the cholesky drivers, and never rewrites the JAX goldens."""
import json

import pytest
import torch

import elemental_tpu_torch as et
from elemental_tpu import analysis as jan
from elemental_tpu_torch import analysis as an
from elemental_tpu_torch.analysis import __main__ as cli
from elemental_tpu_torch.redist.engine import redistribute, transpose_dist
from elemental_tpu_torch.redist.plan import compile_slice_plan
from .torch_analysis_common import jax_trace

GRIDS = [(1, 1), (2, 2)]
MC, MR, VC, STAR = et.MC, et.MR, et.VC, et.STAR
N = 16


def _jax_rules(name, rc):
    plan, closed, log = jax_trace(name, rc)
    found = jan.lint_plan(plan, log, closed)
    found += jan.lint.rule_double_materialization(None, log)
    return sorted((f.rule, name) for f in found)


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_registered_findings_equal_the_jax_lint(rc):
    for name in an.driver_names():
        plan, records, _ = an.trace_driver(name, et.Grid(*rc, device="cpu"))
        found = an.lint_plan(plan, records)
        found += an.lint.rule_double_materialization(None, records)
        assert sorted((f.rule, name) for f in found) == \
            _jax_rules(name, rc), (name, rc)


# ---------------------------------------------------------------------
# seeded regressions
# ---------------------------------------------------------------------

def _g22():
    return et.Grid(2, 2, device="cpu")


def _arg(dtype=torch.float32):
    F = torch.arange(N * N, dtype=torch.float64).reshape(N, N) / N
    return et.from_global(F.to(dtype), MC, MR, _g22())


def _lint(fn, *args, meta=None):
    args = args or (_arg(),)
    plan, records, _ = an.trace_callable(fn, args, grid=_g22(), meta=meta)
    return an.lint_plan(plan, records)


def _toy(round_trip: bool):
    """The planted [MC,MR] -> [VC,STAR] -> [MC,MR] round trip on the
    untouched intermediate, then a full gather."""
    def fn(A):
        if round_trip:
            A = redistribute(redistribute(A, VC, STAR), MC, MR)
        ss = redistribute(A, STAR, STAR)
        return ss.local @ ss.local
    return fn


def test_seeded_round_trip_reported():
    findings = _lint(_toy(round_trip=True))
    assert [f.rule for f in findings] == ["EL002"]
    msg = str(findings[0])
    assert "[MC,MR]->[VC,STAR]" in msg and "[VC,STAR]->[MC,MR]" in msg


def test_round_trip_fix_hint_quotes_the_direct_and_slice_plans():
    hint = _lint(_toy(round_trip=True))[0].fix_hint
    assert "path='direct'" in hint and "[MC,MR]->[VC,STAR]" in hint
    assert "'a2a'" in hint or "'ppermute'" in hint
    assert "round(s)" in hint and "vs the chain's" in hint
    splan = compile_slice_plan((MC, MR), (VC, STAR), (N, N), (2, 2),
                               rows=(0, N // 2))
    assert "compile_slice_plan" in hint and f"rows=(0, {N // 2})" in hint
    assert f"'{splan.kind}'" in hint and f"{splan.rounds} round(s)" in hint


def test_round_trip_removed_passes():
    assert _lint(_toy(round_trip=False)) == []


def test_round_trip_with_intervening_compute_not_flagged():
    def fn(A):
        V = redistribute(A, VC, STAR)
        V = V.with_local(V.local * 2.0)
        return redistribute(V, MC, MR).local
    assert _lint(fn) == []


def test_adjacent_panel_spreads_flag_fusion():
    def fn(A):
        V = redistribute(A, VC, STAR)
        P_mc = redistribute(V, MC, STAR)
        P_mr = redistribute(transpose_dist(V, conj=True), STAR, MR)
        return P_mc.local, P_mr.local
    findings = _lint(fn)
    assert any(f.rule == "EL001" and "panel_spread" in f.message
               for f in findings), [str(f) for f in findings]


def test_f64_promotion_flagged():
    def fn(A):
        return redistribute(A.astype(torch.float64), STAR, STAR).local
    assert any(f.rule == "EL004" for f in _lint(fn))


def test_bf16_leak_flagged_and_opt_in():
    def fn(A):
        return redistribute(A, STAR, STAR, comm_precision="bf16").local
    assert any(f.rule == "EL005" for f in _lint(fn))
    assert _lint(fn, meta={"allow_bf16": True}) == []


def test_loop_invariant_collective_flagged():
    def fn(A):
        acc = None
        for _ in range(4):                  # the same unchanged operand
            y = redistribute(A, STAR, MR).local
            acc = y if acc is None else acc + y
        return acc
    findings = _lint(fn)
    assert [f.rule for f in findings] == ["EL003"] * 3
    assert "hoist" in findings[0].message


# ---------------------------------------------------------------------
# the command line against perf.comm_audit
# ---------------------------------------------------------------------

@pytest.mark.parametrize("cmd", ["diff", "lint"])
def test_cli_lines_and_exit_code_equal_comm_audit(cmd, capsys):
    from perf import comm_audit
    rc_j = comm_audit.main([cmd, "cholesky"])
    out_j = capsys.readouterr().out
    rc_t = cli.main([cmd, "cholesky", "--device", "cpu"])
    out_t = capsys.readouterr().out
    assert (rc_t, out_t) == (rc_j, out_j)
    want = ["ok cholesky_abft 1x1"] if cmd == "diff" else ["0 finding(s)"]
    assert out_t.split("\n")[:1] == want


def test_update_golden_never_rewrites_the_jax_goldens(tmp_path, capsys):
    golden = cli.GOLDEN_ROOT / "comm_plans" / "cholesky_classic__2x2.json"
    before = golden.read_bytes()
    assert cli.main(["diff", "cholesky_classic", "--update-golden",
                     "--device", "cpu"]) == 2
    assert cli.main(["diff", "cholesky_classic", "--update-golden",
                     "--golden-dir", str(cli.GOLDEN_ROOT),
                     "--device", "cpu"]) == 2
    assert golden.read_bytes() == before
    # an explicit directory elsewhere takes the port's own goldens
    assert cli.main(["mem-diff", "cholesky_classic", "--grid", "2x2",
                     "--update-golden", "--golden-dir", str(tmp_path),
                     "--device", "cpu"]) == 0
    assert cli.main(["mem-diff", "cholesky_classic", "--grid", "2x2",
                     "--golden-dir", str(tmp_path), "--device", "cpu"]) == 0
    doc = json.loads((tmp_path / "memory_plans" /
                      "cholesky_classic__2x2.json").read_text())
    assert doc["schema"] == "memory_plan/v1" and doc["peak_bytes"] > 0
    capsys.readouterr()


def test_mem_diff_holds_the_shared_fields_to_the_jax_goldens(capsys):
    assert cli.main(["mem-diff", "lu_calu", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.split("\n")[:2] == \
        ["ok lu_calu 1x1", "ok lu_calu 2x2"]


def test_cli_without_a_card_refuses(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["audit", "qr"]) == 2
    assert "--device cpu" in capsys.readouterr().err
