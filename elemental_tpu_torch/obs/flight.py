"""Fault-triggered flight recorder -> ``flight_record/v1``.

PyTorch port of ``elemental_tpu/obs/flight.py`` (host-only).  A bounded
ring buffer of structured serve events -- lifecycle edges (``edge:<name>``,
fed by :class:`~.lifecycle.RequestTrace`), rejects, circuit-breaker
transitions, health/ABFT flags -- that auto-dumps the last ``capacity``
events the moment a TRIGGER fires, so the seconds BEFORE a fault are
reconstructable after the fact (the serving-tier equivalent of an
aircraft FDR).

Triggers (each produces one ``flight_record/v1`` dump in :attr:`dumps`
and invokes ``on_dump``):

  * ``breaker_open``  -- a serving circuit breaker transitions to OPEN;
  * ``unrecovered``   -- a request finalizes ``status="failed"`` after
    escalation/bisection exhausted recovery;
  * ``quota_storm``   -- ``quota_storm_threshold`` consecutive quota
    rejects (a tenant hammering past its outstanding cap);
  * ``chaos_fault``   -- chaos harness cells announce injected faults;
  * ``manual``        -- anything else (CLI smoke uses this).

DETERMINISM CONTRACT: the recorder touches nothing but its injected
``clock`` -- no wall time, no randomness -- and orders events by a
monotone sequence number taken under the lock, so a chaos cell driven by
a virtual clock and a seeded fault plan produces a BYTE-IDENTICAL dump
on replay (the run-twice-compare oracle of the chaos harness).

Thread-safety: ``record``/``trigger`` are called from the fleet pump,
grid-worker threads, and breaker paths concurrently; one lock serializes
the ring, the sequence counter, and the storm detector.
"""
from __future__ import annotations

import collections
import threading
import time

SCHEMA = "flight_record/v1"

#: trigger vocabulary (informational -- unknown reasons still dump)
TRIGGERS = ("breaker_open", "unrecovered", "quota_storm", "chaos_fault",
            "manual")


def _json_safe(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        return [_json_safe(x) for x in v]
    return str(v)


class FlightRecorder:
    """Bounded ring of structured events + trigger-fired dumps."""

    def __init__(self, *, capacity: int = 256, clock=time.monotonic,
                 quota_storm_threshold: int = 8, on_dump=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self.quota_storm_threshold = int(quota_storm_threshold)
        self.on_dump = on_dump
        self.dumps: list = []
        self._ring = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._total = 0
        self._quota_run = 0

    # ---- recording ---------------------------------------------------
    def record(self, kind: str, **attrs) -> None:
        """Append one structured event; fires ``quota_storm`` when the
        consecutive-quota-reject run reaches the threshold."""
        storm = False
        with self._lock:
            self._seq += 1
            self._total += 1
            ev = {"seq": self._seq, "t": float(self.clock()),
                  "kind": str(kind)}
            for k, v in attrs.items():
                if v is not None:
                    ev[str(k)] = _json_safe(v)
            self._ring.append(ev)
            if kind == "reject":
                if attrs.get("reason") == "quota":
                    self._quota_run += 1
                    if self._quota_run == self.quota_storm_threshold:
                        storm, self._quota_run = True, 0
                else:
                    self._quota_run = 0
        if storm:
            self.trigger("quota_storm",
                         rejects=self.quota_storm_threshold)

    # ---- triggering --------------------------------------------------
    def trigger(self, reason: str, **attrs) -> dict:
        """Dump the ring NOW as a ``flight_record/v1`` doc."""
        with self._lock:
            events = [dict(ev) for ev in self._ring]
            total = self._total
            trig = {"reason": str(reason), "t": float(self.clock()),
                    "seq": self._seq}
            for k, v in attrs.items():
                if v is not None:
                    trig[str(k)] = _json_safe(v)
            doc = {"schema": SCHEMA, "trigger": trig,
                   "capacity": self.capacity, "recorded": total,
                   "dropped": total - len(events), "events": events}
            self.dumps.append(doc)
        if self.on_dump is not None:
            self.on_dump(doc)
        return doc

    # ---- reads -------------------------------------------------------
    def last_dump(self) -> dict | None:
        with self._lock:
            return self.dumps[-1] if self.dumps else None

    def events(self) -> list:
        """Snapshot of the current ring contents (oldest first)."""
        with self._lock:
            return [dict(ev) for ev in self._ring]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
