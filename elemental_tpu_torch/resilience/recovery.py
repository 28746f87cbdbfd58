"""Panel-transaction recovery for the ABFT-guarded factorizations.

PyTorch port of ``elemental_tpu/resilience/recovery.py``.
:func:`run_step` wraps ONE panel step of an :mod:`.abft`-guarded driver
(lu, cholesky, qr) as a transaction.  The step body is a function
``state -> (state', *extras)`` that never writes into ``state``: every
write of a guarded step is functional (``update_view``, ``move_rows``
and ``local_rank_update`` return new tensors; the panel kernels and the
fault plan write into copies), so the pre-step state stays intact while
it is referenced and rollback is "discard the attempt's outputs and call
the body again".  Where the JAX package relies on immutable arrays for
this, the port relies on that discipline, and the tests hold a run
recovered from a one-shot fault bit-equal to the clean guarded run.

Per attempt the runner

  1. announces the panel step to the fault-injection seam
     (``engine.set_fault_step``) so ``FaultSpec(window=...)`` rules can
     target exactly this panel,
  2. runs the body, which records its checksum invariants on the guard,
  3. evaluates the attempt's checks on the host
     (:meth:`AbftGuard.end_attempt`, one device-to-host transfer).

A clean attempt commits.  A violated one is discarded and the body
re-executed -- the ONLY recomputation is this panel step, counted on
``AbftGuard.recompute_count`` -- up to ``guard.max_retries`` retries; a
step still violated after the last retry commits anyway (the tensors are
the best available) and is marked UNRECOVERED, which the guard surfaces
through the bound ``health_report/v1`` monitor and the
``abft_report/v1`` ``ok=False`` verdict so ``certified_solve`` escalates
past the abft rung.

Retries would emit an ``abft:recover`` span on the active tracer; the
port has no tracer yet (``obs.tracer.active_tracer`` is ``None``).
"""
from __future__ import annotations


def run_step(guard, step: int, body, state):
    """Run one guarded panel step as a transaction (see module doc).

    ``body(state)`` must not write into ``state`` and may return any
    tuple whose first element is the new state; whatever it returns is
    returned unchanged for the committing attempt.
    """
    import contextlib

    from ..redist.engine import set_fault_step
    from ..obs.tracer import active_tracer

    def attempt_once(attempt):
        set_fault_step(step)
        guard.start_attempt()
        try:
            res = body(state)
        finally:
            set_fault_step(None)
        return res, guard.end_attempt(step, attempt)

    attempts = guard.max_retries + 1
    result, viols = attempt_once(0)
    for attempt in range(1, attempts):
        if not viols:
            break
        guard.note_violation(viols)
        # roll back: drop the attempt's outputs, re-execute this panel
        guard.note_recompute()
        tr = active_tracer()
        phases = ",".join(sorted({v["phase"] for v in viols}))
        span = tr.span("abft:recover", step=step, attempt=attempt,
                       violated=phases) if tr is not None \
            else contextlib.nullcontext()
        with span:
            result, viols = attempt_once(attempt)
        if not viols:
            guard.note_recovered(step)
    else:
        if viols:
            guard.note_violation(viols)
            guard.note_unrecovered(step)
    guard.note_panel()
    return result
