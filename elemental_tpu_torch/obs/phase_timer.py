"""``PhaseTimer``: per-phase wall-clock attribution (``phase_timings/v1``).

PyTorch port of ``elemental_tpu/obs/phase_timer.py``: a thin shim over
the span tracer (:mod:`.tracer`).  Ticks land as the tracer's
:class:`~.tracer.PhaseRecord` intervals and :meth:`PhaseTimer.report`
aggregates them into the ``phase_timings/v1`` document, byte-identical to
the JAX package's for the same records.

Any driver that accepts a ``timer`` argument calls
``timer.tick(phase, step, *tensors)`` at its phase boundaries.  The timer
waits for the device of the phase's outputs and charges the elapsed
wall-clock since the previous tick to ``(phase, step)``::

    from elemental_tpu_torch.obs import PhaseTimer
    t = PhaseTimer()
    LU, perm = et.lu(A, nb=2048, timer=t)
    print(t.json(driver="lu", n=n, nb=2048))

Schema (LU emits panel/swap/solve/update, Cholesky diag/panel/spread/
update and ``tail`` on the crossover step)::

    {"schema": "phase_timings/v1",
     "steps":  [{"step": 0, "panel": s, "swap": s, "solve": s, "update": s},
                ...],                      # seconds; phases may be absent
     "totals": {"panel": s, "swap": s, "solve": s, "update": s},
     "total_seconds": s,
     ...caller metadata (driver, n, nb, device, ...)}

Timing note: CUDA launches are asynchronous, so the sync INSIDE tick is
what makes the attribution honest; each phase's time includes its share
of launch overhead, and the host's run-ahead ends at every tick.
"""
from __future__ import annotations

import json

from .tracer import Tracer

SCHEMA = "phase_timings/v1"

#: canonical phase order for reports (drivers emit a subset: LU ticks
#: panel/swap/solve/update, Cholesky diag/panel/spread/update + tail,
#: QR panel/update, gemm panel, trsm solve/update, herk spread/update)
PHASES = ("diag", "panel", "swap", "solve", "spread", "update", "tail")


class PhaseTimer:
    """Accumulates (phase, step, seconds) records from a driver's ticks.

    Backed by a private (metrics-silent) :class:`Tracer` whose tick
    channel does the sync + interval bookkeeping; an externally supplied
    ``tracer`` lets callers merge PhaseTimer ticks into a larger trace.
    """

    def __init__(self, tracer: Tracer | None = None):
        self.tracer = tracer if tracer is not None else Tracer(metrics=False)
        self._chan = self.tracer.channel("phase_timer")
        self._chan._t = None            # unarmed until start()/first tick

    def start(self):
        """(Re)arm the clock at a driver's entry."""
        self._chan.start()

    def tick(self, phase, step, *arrays):
        """Wait for ``arrays`` and charge the elapsed time to (phase, step)."""
        self._chan.tick(phase, step, *arrays)

    @property
    def records(self) -> list[dict]:
        """The record shape: [{"phase", "step", "seconds"}]."""
        return [{"phase": r.phase, "step": r.step, "seconds": r.seconds}
                for r in self.tracer.phases if r.call == self._chan.call]

    def report(self, **meta) -> dict:
        """The schema dict above; ``meta`` keys merge at top level."""
        steps: dict[int, dict] = {}
        totals: dict[str, float] = {}
        for r in self.records:
            d = steps.setdefault(r["step"], {})
            d[r["phase"]] = d.get(r["phase"], 0.0) + r["seconds"]
            totals[r["phase"]] = totals.get(r["phase"], 0.0) + r["seconds"]
        out = {
            "schema": SCHEMA,
            "steps": [{"step": k, **v} for k, v in sorted(steps.items())],
            "totals": {p: totals[p] for p in PHASES if p in totals}
            | {p: t for p, t in totals.items() if p not in PHASES},
            "total_seconds": sum(totals.values()),
        }
        out.update(meta)
        return out

    def json(self, **meta) -> str:
        return json.dumps(self.report(**meta))
