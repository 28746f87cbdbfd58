"""Rule-based lints over a recorded run's comm plan and memory plan.

The twin of the JAX package's ``analysis/lint.py``: the same rule ids,
slugs and messages, read off what the port's engine recorded instead of
a jaxpr.  Comm rules (:func:`lint_plan`):

  EL001 fuse-adjacent-gathers   two back-to-back redistributions of the
        same [VC,STAR]/[STAR,VC] panel onto the [MC,STAR]+[STAR,MR]
        operand pair, which :func:`panel_spread` does in one round.
  EL002 redundant-round-trip    a redistribution whose output goes
        untouched (the same tensor) into one straight back to the source
        distribution; the fix hint quotes the one-shot plan of
        :func:`~..redist.plan.compile_plan`.
  EL003 loop-invariant-collective   the same unchanged source tensor
        (same ``in_id`` and ``_version``) redistributed to the same
        target twice in one run: the second could reuse the first
        (:func:`~.record_walk.find_loop_invariant_collectives`).
  EL004 f64-promotion           a collective moving float64 / complex128
        in a run from <= 32-bit inputs.
  EL005 bf16-leak               a bfloat16 collective without the opt-in
        (``allow_bf16`` in the driver spec).

Memory rules (:func:`lint_memory`), over a measured
:class:`~.memory.MemoryPlan`:

  EL006 peak-over-budget        the measured per-device peak exceeds the
        driver's budget (``mem_budget_factor`` x input + output
        residency; the JAX registry's factors).
  EL007 smem-spill              an ``lu_panel`` dispatch whose slab of
        rows does not fit in the card's shared memory, so the kernel
        works the panel in device memory (:mod:`.memory`'s closed form on
        the card's constants).
  EL008 missing-donation        an input whose (shape, dtype) matches an
        output but is not in the declared donated set; opt-in through
        ``meta["donated"]``.
  EL009 double-materialization  two or more [STAR,STAR] gathers of the
        same source operand.

Findings come back sorted by rule id; an empty list is a clean run.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .record_walk import find_loop_invariant_collectives

_WIDE = ("float64", "complex128")


@dataclasses.dataclass(frozen=True)
class LintFinding:
    rule: str          # "EL00x"
    name: str          # short rule slug
    message: str       # human-readable, names the offending site
    severity: str = "warning"
    fix_hint: str = "" # concrete rewrite suggestion (lint --fix-hint)

    def __str__(self):
        return f"{self.rule} [{self.name}] {self.message}"


# ---------------------------------------------------------------------
# comm rules
# ---------------------------------------------------------------------

def _is_v_panel(dist) -> bool:
    names = tuple(d.value for d in dist)
    return names in (("VC", "STAR"), ("STAR", "VC"),
                     ("VR", "STAR"), ("STAR", "VR"))


def _spread_target(dist) -> bool:
    names = tuple(d.value for d in dist)
    return names in (("MC", "STAR"), ("STAR", "MR"),
                     ("MR", "STAR"), ("STAR", "MC"))


def rule_fuse_adjacent_gathers(plan, redist_log) -> list:
    """EL001: the panel and its adjoint spread issued as separate calls."""
    out = []
    recs = [r for r in redist_log if r.kind == "redistribute"]
    for a, b in zip(recs, recs[1:]):
        if not (_is_v_panel(a.src) and _spread_target(a.dst)):
            continue
        if not (_is_v_panel(b.src) and _spread_target(b.dst)):
            continue
        if a.dst == b.dst:
            continue
        if a.gshape not in (b.gshape, b.gshape[::-1]):
            continue
        out.append(LintFinding(
            "EL001", "fuse-adjacent-gathers",
            f"adjacent panel spreads {a.label} then {b.label} on a "
            f"{a.gshape} panel: fuse into one panel_spread() round "
            f"(one all_gather instead of separate gather chains)"))
    return out


def _slice_rewrite_hint(rec, z: int) -> str:
    """The sub-range refinement of the EL002 rewrite: the
    ``compile_slice_plan`` of a representative half-row range."""
    from ..redist.plan import compile_slice_plan
    gs = tuple(rec.grid_shape)
    m, n = rec.gshape
    rows = (0, max(int(m) // 2, 1))
    try:
        splan = compile_slice_plan(rec.src, rec.dst, rec.gshape, gs,
                                   rows=rows)
    except (ValueError, KeyError):
        return ""
    if splan is None:
        return ""
    return (f"; consuming a sub-range only? compile_slice_plan(src, dst, "
            f"{tuple(rec.gshape)}, {gs}, rows={rows}) one-shots the "
            f"A[{rows[0]}:{rows[1]}, :] slice as a '{splan.kind}' plan = "
            f"{splan.rounds} round(s) / ~{splan.wire_bytes(z)} B -- "
            f"pay for the block you touch, not the matrix")


def _direct_rewrite_hint(rec) -> str:
    """The one-shot rewrite of one chained leg: the compiled src->dst
    plan's rounds and bytes next to the chain's."""
    gs = tuple(rec.grid_shape or ())
    if len(gs) != 2:
        return ""
    from ..redist.engine import chain_cost
    from ..redist.plan import compile_plan
    plan = compile_plan(rec.src, rec.dst, rec.gshape, gs)
    if plan is None:
        return ""
    z = np.dtype(rec.dtype).itemsize
    rounds_c, bytes_c = chain_cost(rec.src, rec.dst, rec.gshape, gs, z)
    return (f"if the {rec.dst[0].value}/{rec.dst[1].value} form is "
            f"actually consumed, route it as redistribute(..., "
            f"path='direct'): one-shot '{plan.kind}' plan for "
            f"{rec.label} at {rec.gshape} on {gs[0]}x{gs[1]} = "
            f"{plan.rounds} round(s) / ~{plan.wire_bytes(z)} B vs the "
            f"chain's {rounds_c} round(s) / ~{bytes_c} B; otherwise "
            f"delete both legs" + _slice_rewrite_hint(rec, z))


def rule_redundant_round_trip(plan, redist_log) -> list:
    """EL002: A->X then X->A on the untouched intermediate."""
    out = []
    recs = [r for r in redist_log if r.kind == "redistribute"]
    by_out = {}
    for r in recs:
        for oid in r.out_ids:
            by_out[oid] = r
    for r in recs:
        prev = by_out.get(r.in_id)
        if prev is None or prev is r:
            continue
        if prev.src == r.dst and prev.dst == r.src \
                and prev.gshape == r.gshape:
            out.append(LintFinding(
                "EL002", "redundant-round-trip",
                f"{prev.label} then {r.label} on the SAME untouched "
                f"{r.gshape} operand: the round trip is a no-op costing "
                f"two redistribution rounds",
                fix_hint=_direct_rewrite_hint(prev)))
    return out


def rule_loop_invariant(plan, redist_log=()) -> list:
    """EL003: one unchanged source redistributed to one target twice."""
    out = []
    for label, (first, again) in find_loop_invariant_collectives(redist_log):
        out.append(LintFinding(
            "EL003", "loop-invariant-collective",
            f"{label} at entry {again} moves the same unchanged operand "
            f"as entry {first}: hoist it and reuse the first result"))
    return out


def rule_f64_promotion(plan) -> list:
    """EL004: wide dtypes on the wire from narrow inputs."""
    in_dtypes = plan.meta.get("input_dtypes") or [plan.meta.get("dtype")]
    if any(str(d) in _WIDE for d in in_dtypes if d):
        return []
    out = []
    seen = set()
    for ev in plan.events:
        if ev.dtype in _WIDE and (ev.prim, ev.dtype, ev.shape) not in seen:
            seen.add((ev.prim, ev.dtype, ev.shape))
            out.append(LintFinding(
                "EL004", "f64-promotion",
                f"{ev.prim} moves {ev.dtype} {ev.shape} at "
                f"{'/'.join(ev.path)} but the traced inputs are "
                f"{[str(d) for d in in_dtypes]}: unintended promotion "
                f"doubles wire bytes"))
    return out


def rule_bf16_leak(plan) -> list:
    """EL005: bf16 collectives without the opt-in."""
    if plan.meta.get("allow_bf16"):
        return []
    out = []
    seen = set()
    for ev in plan.events:
        if ev.dtype == "bfloat16" and (ev.prim, ev.shape) not in seen:
            seen.add((ev.prim, ev.shape))
            out.append(LintFinding(
                "EL005", "bf16-leak",
                f"{ev.prim} moves bfloat16 {ev.shape} at "
                f"{'/'.join(ev.path)} without the update_precision "
                f"opt-in: bf16 on the wire halves mantissa silently"))
    return out


def lint_plan(plan, redist_log=()) -> list:
    """Run every comm rule over a plan and its run's records; findings
    sorted by rule id (empty == clean)."""
    findings = []
    findings += rule_fuse_adjacent_gathers(plan, redist_log)
    findings += rule_redundant_round_trip(plan, redist_log)
    findings += rule_loop_invariant(plan, redist_log)
    findings += rule_f64_promotion(plan)
    findings += rule_bf16_leak(plan)
    return sorted(findings, key=lambda f: (f.rule, f.message))


# ---------------------------------------------------------------------
# memory rules
# ---------------------------------------------------------------------

def peak_ratio(mplan) -> float:
    """The measured per-device peak over the input + output residency
    (what EL006 holds against the driver's factor)."""
    base = mplan.stats.args_bytes + mplan.stats.outs_bytes
    return (mplan.peak_bytes + mplan.stats.nonstatic_peak_bytes) \
        / max(base, 1)


def rule_mem_budget(mplan, budget_factor: float) -> list:
    """EL006: the measured peak over the declared per-driver budget."""
    base = mplan.stats.args_bytes + mplan.stats.outs_bytes
    budget = int(budget_factor * max(base, 1))
    total = mplan.peak_bytes + mplan.stats.nonstatic_peak_bytes
    if total <= budget:
        return []
    at = "/".join(mplan.stats.peak_path) or "<top>"
    msg = (f"{mplan.driver} on {mplan.grid[0]}x{mplan.grid[1]}: peak live "
           f"{total} B exceeds the declared budget {budget} B "
           f"({budget_factor:g}x the {base} B input+output residency); "
           f"high-water at {at} ({mplan.stats.peak_prim})")
    return [LintFinding(
        "EL006", "peak-over-budget", msg,
        fix_hint=(f"either the driver legitimately stages this much "
                  f"(raise MEM_BUDGET_FACTORS[{mplan.driver!r}] in "
                  f"analysis/drivers.py and say why) or a gather is "
                  f"materializing more than its consumer touches -- "
                  f"check the replicated census "
                  f"({mplan.replicated.get('count', 0)} site(s), max "
                  f"extra {mplan.replicated.get('max_extra_bytes', 0)} B)"))]


def rule_smem_spill(panel_checks) -> list:
    """EL007: ``lu_panel`` dispatches whose slab leaves shared memory."""
    out = []
    seen = set()
    for chk in panel_checks:
        if not chk.spills or (chk.op, chk.shape) in seen:
            continue
        seen.add((chk.op, chk.shape))
        out.append(LintFinding(
            "EL007", "smem-spill",
            f"{chk.op} panel {chk.shape} {chk.dtype}: its slab of "
            f"{chk.slab_bytes} B per thread block exceeds the "
            f"{chk.budget} B of dynamic shared memory beside the column "
            f"kernel, so lu_panel works the panel in device memory",
            fix_hint=("split the panel's rows (a narrower grid column "
                      "or a CALU tournament panel) so each slab fits, "
                      "or accept the device-memory column loop")))
    return out


def rule_missing_donation(mplan) -> list:
    """EL008: an input whose (shape, dtype) matches an output but is not
    donated.  Opt-in: only when ``meta["donated"]`` declares the set."""
    donated = mplan.meta.get("donated")
    if donated is None:
        return []
    donated = set(int(i) for i in donated)
    out_sigs = list(mplan.stats.out_sigs)
    findings = []
    for i, sig in enumerate(mplan.stats.in_sigs):
        if i in donated or sig not in out_sigs:
            continue
        findings.append(LintFinding(
            "EL008", "missing-donation",
            f"{mplan.driver}: input {i} {sig[0]} {sig[1]} matches an "
            f"output but is not in the donated set {sorted(donated)}: "
            f"the buffer is held live across the whole call for nothing",
            fix_hint=f"let the call write its result into input {i} "
                     f"(an out= buffer or an in-place driver), halving "
                     f"this operand's residency"))
    return findings


def rule_double_materialization(mplan, redist_log) -> list:
    """EL009: >= 2 full-matrix gathers of the SAME source operand."""
    by_src = {}
    for rec in redist_log:
        if rec.kind != "redistribute":
            continue
        names = tuple(d.value for d in rec.dst)
        if names != ("STAR", "STAR"):
            continue
        by_src.setdefault((rec.in_id, rec.gshape, rec.dtype),
                          []).append(rec)
    out = []
    for (in_id, gshape, dtype), recs in sorted(
            by_src.items(), key=lambda kv: repr(kv[0][1:])):
        if len(recs) < 2:
            continue
        p = 1
        gs = tuple(recs[0].grid_shape or ())
        if len(gs) == 2:
            p = max(gs[0] * gs[1], 1)
        out.append(LintFinding(
            "EL009", "double-materialization",
            f"{len(recs)} separate [*,*] gathers of the SAME {gshape} "
            f"{dtype} operand: each keeps {p} live replicas per grid -- "
            f"gather once and reuse the replicated form",
            fix_hint="hoist the redistribute(.., STAR, STAR) above the "
                     "consumers (or thread the gathered operand through) "
                     "so the full-matrix materialization is paid once"))
    return out


def lint_memory(mplan, redist_log=(), budget_factor: float = None,
                panel_checks=None) -> list:
    """Run the memory rules over one :class:`~.memory.MemoryPlan`.

    ``redist_log`` should be the comm trace's records (they keep their
    tensors alive, so ``in_id`` s are unique).  ``budget_factor``
    defaults to the registry's factor for the driver (4.0 unregistered);
    ``panel_checks`` to the EL007 sweep of the driver's own panels (the
    lu drivers at the plan's n / nb / dtype)."""
    if budget_factor is None:
        from .drivers import DRIVERS
        spec = DRIVERS.get(mplan.driver)
        budget_factor = spec.mem_budget_factor if spec is not None else 4.0
    if panel_checks is None:
        from .memory import panel_smem_checks
        n, nb = mplan.meta.get("n"), mplan.meta.get("nb")
        panel_checks = []
        if n and nb:
            panel_checks = panel_smem_checks(
                mplan.driver.split("_")[0], int(n), int(nb),
                mplan.meta.get("dtype", "float32"))
    findings = []
    findings += rule_mem_budget(mplan, budget_factor)
    findings += rule_smem_spill(panel_checks)
    findings += rule_missing_donation(mplan)
    findings += rule_double_materialization(mplan, redist_log)
    return sorted(findings, key=lambda f: (f.rule, f.message))
