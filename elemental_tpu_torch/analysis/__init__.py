"""Comm plans and memory plans of a recorded run, and their lint.

The twin of the JAX package's ``analysis`` (its public names, its
``comm_plan/v1`` and ``memory_plan/v1`` documents, its lint rules
EL001-EL009).  The JAX package traces a driver into a jaxpr and walks it;
the port has no jaxpr, so it runs the driver once on seeded inputs on a
virtual grid and reads what the engine recorded: every redistribution
entry (:class:`~..redist.engine.RedistRecord`), mapped to the collectives
the JAX lowering emits for it on a real grid, and the collectives the
drivers note themselves.  For all 33 registered drivers on 1x1 and 2x2
the port's comm plan equals the JAX package's live trace key for key.
CLI: ``python -m elemental_tpu_torch.analysis
{audit,diff,lint,mem,mem-diff,mem-lint}``.

Names whose meaning changed, because there is no jaxpr:

* ``collect_events(records, notes)`` takes the run's records and the
  driver-level collective notes, not a closed jaxpr; every event ran, so
  each has ``count`` 1 and ``static`` true.  ``count_record_calls``
  stands for ``count_pjit_calls`` (it counts recorded entries by label).
* ``find_loop_invariant_collectives(records)`` finds one unchanged
  source tensor redistributed to one target twice (same ``in_id``,
  same ``_version``), where the JAX walker finds collectives on loop
  constants inside a scan body.
* ``trace_driver`` / ``trace_callable`` return ``(plan, records,
  notes)`` where the JAX functions return ``(plan, closed_jaxpr,
  redist_log)``; ``lint_plan(plan, records)`` needs no jaxpr.
* ``measure_call`` / ``MeterStats`` stand for ``analyze_jaxpr`` /
  ``WalkStats``: the peak is measured by the allocator's events, not
  walked; ``peak_path`` names the driver phase and ``peak_prim`` the
  aten op.
* The port's panel kernels have no VMEM gate.  ``kernel_smem_bytes``,
  ``check_panel_smem``, ``panel_smem_checks``, ``PanelSmemCheck`` and
  ``SMEM_ROWS`` stand for ``kernel_vmem_bytes``, ``check_panel_vmem``,
  ``panel_vmem_checks``, ``PanelVmemCheck`` and ``PANEL_GATE_COPIES``:
  EL007 flags an ``lu_panel`` dispatch whose slab of rows leaves shared
  memory on the card.
"""
from .record_walk import (CollectiveEvent, COLLECTIVE_PRIMS, collect_events,
                          count_record_calls, estimate_bytes,
                          find_loop_invariant_collectives)
from .plan import SCHEMA, CommPlan, plan_from_parts, golden_doc, diff_docs
from .lint import LintFinding, lint_plan, lint_memory, peak_ratio
from .memory import (MEM_SCHEMA, MemoryPlan, MeterStats, HighWater,
                     PanelSmemCheck, SmemRow, SMEM_ROWS, measure_call,
                     memory_plan, trace_memory, replication_census,
                     golden_mem_doc, diff_mem_docs, kernel_smem_bytes,
                     check_panel_smem, panel_smem_checks, panel_shapes,
                     spill_rows)
from .drivers import (DRIVERS, MEM_BUDGET_FACTORS, LOOKAHEAD_PAIRS,
                      CALU_PAIRS, COMMQ_PAIRS, COMMQ_MIN_BYTE_RATIO,
                      DIRECT_PAIRS, DEFAULT_N, DEFAULT_NB, DEFAULT_XOVER,
                      driver_names, trace_driver, trace_callable,
                      storage_shape, build_driver, panel_impl_override)

__all__ = [
    "CollectiveEvent", "COLLECTIVE_PRIMS", "collect_events",
    "count_record_calls", "estimate_bytes",
    "find_loop_invariant_collectives",
    "SCHEMA", "CommPlan", "plan_from_parts", "golden_doc", "diff_docs",
    "LintFinding", "lint_plan", "lint_memory", "peak_ratio",
    "MEM_SCHEMA", "MemoryPlan", "MeterStats", "HighWater", "PanelSmemCheck",
    "SmemRow", "SMEM_ROWS", "measure_call", "memory_plan", "trace_memory",
    "replication_census", "golden_mem_doc", "diff_mem_docs",
    "kernel_smem_bytes", "check_panel_smem", "panel_smem_checks",
    "panel_shapes", "spill_rows",
    "DRIVERS", "MEM_BUDGET_FACTORS", "LOOKAHEAD_PAIRS", "CALU_PAIRS",
    "COMMQ_PAIRS", "COMMQ_MIN_BYTE_RATIO", "DIRECT_PAIRS", "DEFAULT_N",
    "DEFAULT_NB", "DEFAULT_XOVER", "driver_names", "trace_driver",
    "trace_callable", "storage_shape", "build_driver",
    "panel_impl_override",
]

#: each JAX ``analysis.__all__`` name that has no port twin of its own
#: name, with the port's counterpart
RENAMED = {
    "count_pjit_calls": "count_record_calls",
    "WalkStats": "MeterStats",
    "analyze_jaxpr": "measure_call",
    "PanelVmemCheck": "PanelSmemCheck",
    "PANEL_GATE_COPIES": "SMEM_ROWS",
    "kernel_vmem_bytes": "kernel_smem_bytes",
    "check_panel_vmem": "check_panel_smem",
    "panel_vmem_checks": "panel_smem_checks",
}
