"""Resilience: numerical-health guards, certified solves, fault injection.

PyTorch port of ``elemental_tpu/resilience/``, whole.  Silent NaN /
growth blowups are the failure mode of large factorizations, not
crashes; this package makes numerical corruption DETECTED, REPORTED and
RECOVERED:

  :mod:`.health`   per-phase health guards riding the drivers' tick-hook
                   seam (``lu(..., health=...)``) -> ``health_report/v1``
  :mod:`.certify`  ``certified_solve``: true-residual certificate +
                   iterative refinement + the deterministic escalation
                   ladder (quant -> fast -> refine -> abft -> fp32 ->
                   classic), deadline-boundable via ``deadline=``
  :mod:`.faults`   seeded ``FaultPlan`` corruption of engine payloads and
                   of the drivers' local panel outputs (the ``'compute'``
                   target), installed via :func:`fault_injection`, the
                   ``redist.engine`` seam
  :mod:`.abft`     checksum-guarded factorizations: ``lu(..., abft=)`` /
                   ``cholesky(..., abft=)`` / ``qr(..., abft=)`` verify
                   Huang-Abraham column-sum invariants per panel ->
                   ``abft_report/v1``
  :mod:`.recovery` the panel-transaction layer: a violated panel step is
                   rolled back and re-executed (bounded retries), so a
                   transient fault costs ONE recomputed panel instead of
                   a full re-solve
"""
from ..redist.engine import fault_injection
from .health import (HEALTH_SCHEMA, HealthMonitor, attach_health,
                     factor_diag_info, last_health_report)
from .certify import (CERT_SCHEMA, LADDER_NAMES, Rung, certified_solve,
                      default_ladder, default_tol)
from .faults import (FAULT_KINDS, FAULT_TARGETS, FaultEvent, FaultPlan,
                     FaultSpec, logs_identical)
from .abft import (ABFT_SCHEMA, AbftGuard, abft_cholesky, abft_lu,
                   abft_qr, last_abft_report)
from .recovery import run_step

__all__ = [
    "HEALTH_SCHEMA", "HealthMonitor", "attach_health", "factor_diag_info",
    "last_health_report",
    "CERT_SCHEMA", "LADDER_NAMES", "Rung", "certified_solve",
    "default_ladder", "default_tol",
    "FAULT_KINDS", "FAULT_TARGETS", "FaultEvent", "FaultPlan", "FaultSpec",
    "logs_identical", "fault_injection",
    "ABFT_SCHEMA", "AbftGuard", "abft_cholesky", "abft_lu", "abft_qr",
    "last_abft_report", "run_step",
]
