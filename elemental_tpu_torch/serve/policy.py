"""Resilience policy: retry/backoff, circuit breaking, degradation.

PyTorch port of ``elemental_tpu/serve/policy.py`` (host-only).  The
decision layer between the service and ``certified_solve``.  Three
policies, all deterministic under replay (seeded jitter,
injectable clocks):

  * **Retry with exponential backoff + jitter** -- a request whose
    escalation fails may be retried (a fresh ``certified_solve`` run
    absorbs transient faults the first run hit); delays are
    ``base * 2^attempt * (1 + jitter*u)`` with ``u`` drawn from a
    per-(seed, request, attempt) ``numpy`` stream -- the same
    determinism contract as :class:`~elemental_tpu_torch.resilience.FaultPlan`
    -- and always clamped to the request's remaining deadline.

  * **Per-bucket circuit breaker** -- ``threshold`` CONSECUTIVE
    certification failures of a bucket's fast path trip it OPEN: new
    submissions reject fast (``serve_reject/v1`` reason
    ``breaker_open``), queued requests bypass the poisoned fast path
    straight to escalation.  After ``cooldown`` seconds the breaker goes
    HALF-OPEN and admits ONE probe batch; success closes it, failure
    re-opens.  State is a gauge (``serve_breaker_state``: 0 closed /
    1 open / 2 half-open) and every transition a counter
    (``serve_breaker_transitions``) on the obs metrics registry.

  * **Graceful degradation** -- the EQuARX-style load-aware trade
    (arXiv 2506.17615): under queue pressure escalations START at the
    cheap-but-narrow ``quant`` rung (int8 wire + refinement) and climb
    only within the remaining deadline; an unloaded service starts at
    the full-wire ``fast`` rung instead, spending bandwidth to skip the
    quant rung's refinement budget.  :func:`select_ladder` is the single
    decision point.
"""
from __future__ import annotations

import time

import numpy as np

from ..obs import metrics as _metrics
from ..resilience.certify import default_ladder

#: breaker states (gauge encoding pinned by tests/serve)
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_GAUGE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

#: queue pressure (depth / capacity) at or above which escalations start
#: at the quant rung
DEGRADE_PRESSURE = 0.5


class RetryPolicy:
    """Deterministic exponential backoff + jitter, deadline-clamped."""

    def __init__(self, *, retries: int = 1, base_s: float = 0.05,
                 jitter: float = 0.5, seed: int = 0):
        self.retries = max(int(retries), 0)
        self.base_s = float(base_s)
        self.jitter = float(jitter)
        self.seed = int(seed)

    def delay_s(self, request_id: int, attempt: int,
                deadline=None) -> float:
        """Backoff before retry ``attempt`` (1-based) of ``request_id``;
        0 means retry immediately, negative means do not retry (no
        budget left)."""
        rng = np.random.default_rng(
            [self.seed, int(request_id), int(attempt)])
        d = self.base_s * (2.0 ** (attempt - 1)) \
            * (1.0 + self.jitter * float(rng.random()))
        if deadline is not None:
            rem = deadline.remaining()
            if rem <= 0.0:
                return -1.0
            d = min(d, max(rem - self.base_s, 0.0))
        return d


class CircuitBreaker:
    """One bucket's trip-open / half-open-probe / close state machine.

    Purely clock-driven (no threads): :meth:`allow` both reports whether
    the fast path may run AND performs the open -> half-open transition
    when the cooldown has elapsed.  ``record_success`` /
    ``record_failure`` feed it certification outcomes."""

    def __init__(self, bucket_key: str, *, threshold: int = 3,
                 cooldown_s: float = 1.0, clock=time.monotonic,
                 grid: str | None = None, flight=None):
        self.bucket_key = str(bucket_key)
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        #: owning fleet member: labels the breaker metric series per
        #: grid so one pool member tripping is attributable; None
        #: (direct single-service) keeps the bucket-only label set
        self.grid = grid
        #: flight recorder: every transition is a structured
        #: event; tripping OPEN is a DUMP TRIGGER -- the retrospective
        #: record of the requests that burned the breaker down
        self.flight = flight
        self.state = CLOSED
        self.failures = 0            # consecutive certification failures
        self.opened_at: float | None = None
        self._gauge()

    # ---- transitions -------------------------------------------------
    def _labels(self) -> dict:
        if self.grid is None:
            return {"bucket": self.bucket_key}
        return {"bucket": self.bucket_key, "grid": self.grid}

    def _gauge(self) -> None:
        _metrics.set_gauge("serve_breaker_state", _STATE_GAUGE[self.state],
                           **self._labels())

    def _transition(self, state: str) -> None:
        if state == self.state:
            return
        prev, self.state = self.state, state
        _metrics.inc("serve_breaker_transitions", to=state,
                     **self._labels())
        self._gauge()
        if self.flight is not None:
            self.flight.record("breaker", bucket=self.bucket_key,
                               grid=self.grid, frm=prev, to=state,
                               failures=self.failures)
            if state == OPEN:
                self.flight.trigger("breaker_open",
                                    bucket=self.bucket_key, grid=self.grid,
                                    failures=self.failures)

    def allow(self) -> bool:
        """May the fast path run?  Closed: yes.  Open: no, unless the
        cooldown elapsed -- then transition to half-open and admit ONE
        probe.  Half-open: the probe is already in flight, no."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self.opened_at is not None \
                    and self.clock() - self.opened_at >= self.cooldown_s:
                self._transition(HALF_OPEN)
                return True
            return False
        return False                 # HALF_OPEN: one probe at a time

    def record_success(self) -> None:
        self.failures = 0
        if self.state in (HALF_OPEN, OPEN):
            self.opened_at = None
            self._transition(CLOSED)

    def record_failure(self) -> None:
        if self.state == HALF_OPEN:
            self.opened_at = self.clock()    # probe failed: re-open
            self._transition(OPEN)
            return
        self.failures += 1
        if self.state == CLOSED and self.failures >= self.threshold:
            self.opened_at = self.clock()
            self._transition(OPEN)

    def to_doc(self) -> dict:
        return {"bucket": self.bucket_key, "state": self.state,
                "consecutive_failures": self.failures,
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s}


def select_ladder(op: str, pressure: float,
                  degrade_pressure: float = DEGRADE_PRESSURE):
    """The degradation decision: the escalation ladder for one request.

    ``pressure`` is queue depth / service capacity.  At or above
    ``degrade_pressure`` the FULL ladder runs, quant rung first (cheap
    narrow wire, refinement pays it back); below it the quant rung is
    skipped -- full-precision wire straight away, nothing to refine
    back.  Deadline enforcement happens inside ``certified_solve``.

    Every returned ladder includes the 'abft' rung ahead of
    the fp32/classic refactorizations: a batch member that failed on a
    TRANSIENT fault gets panel-granular checksum recovery -- one
    recomputed panel inside the guarded driver -- before the service
    pays for bisect re-execution or a whole-solve escalation."""
    rungs = default_ladder(op)
    if pressure >= degrade_pressure:
        return rungs
    return tuple(r for r in rungs if r.name != "quant")
