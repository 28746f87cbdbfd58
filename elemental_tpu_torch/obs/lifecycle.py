"""Per-request lifecycle tracing -> ``serve_timeline/v1``.

PyTorch port of ``elemental_tpu/obs/lifecycle.py`` (host-only; the
serving slice reads it).  The serving tier's request-level twin of the driver span tracer: one
:class:`RequestTrace` rides each request through the whole fleet stack
and timestamps every lifecycle EDGE it crosses --

    ================  ====================================================
    edge              marked by
    ========================  ============================================
    ``submitted``     fleet/async/service ``submit()`` entry
    ``tenant_queued``  ``FairScheduler.push`` (fleet tenant lane entry)
    ``admitted``      ``AdmissionController.admit`` success (via service)
    ``shed``          any reject path, with ``reason=`` attribution
    ``staged``        ``Executor.stage`` (operands packed + compiled)
    ``dispatched``    ``Executor.dispatch`` (async launch)
    ``collected``     ``Executor.collect`` (results on host)
    ``certified``     ``SolverService._certify`` (residual measured)
    ``escalated``     ``SolverService._escalate`` (dense-path rerun)
    ``done``          ``SolverService._finalize`` (terminal result)
    ``rejected``      terminal edge of every reject
    ========================  ============================================

Edges may repeat (a bisected batch stages/collects/certifies twice); the
contract is MONOTONE timestamps under the injected clock, first edge
``submitted``, terminal edge ``done``/``rejected``.  Attribution
(``tenant``/``grid``/``bucket``/``op``) is learned as the request moves
-- the fleet stamps the tenant at submit, the routed member stamps its
grid name at admission -- and every mark is mirrored to

  * the member-shared :class:`~.flight.FlightRecorder`
    (when attached), so the seconds before a fault are reconstructable;
  * the ACTIVE :class:`~.tracer.Tracer` as a
    ``lifecycle:<edge>`` instant carrying ``flow=<request id>``, which
    the Chrome-trace exporter links into ``ph: s/t/f`` flow events --
    the Perfetto arrows hopping a request across grid-worker tracks.

``to_doc()`` renders the STABLE ``serve_timeline/v1`` sub-document that
``serve_result/v1``/``serve_reject/v1`` carry under ``"timeline"``;
:func:`check_timeline` is the completeness/monotonicity oracle the tests
and the serving tier's smoke run.

Thread-safety: marks arrive from the submitting thread, the fleet pump,
and grid-worker threads; the per-trace lock serializes them.
"""
from __future__ import annotations

import threading
import time

from . import tracer as _tracer

SCHEMA = "serve_timeline/v1"

#: canonical edge vocabulary (extra edges are allowed, these are known)
EDGES = ("submitted", "tenant_queued", "admitted", "shed", "staged",
         "dispatched", "collected", "certified", "escalated", "done",
         "rejected")

#: edges every successful solve must have crossed
REQUIRED_OK = ("submitted", "admitted", "done")

#: additional edges for a batch-path (fastpath) solve
BATCH_EDGES = ("staged", "dispatched", "collected", "certified")


def _json_safe(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        return [_json_safe(x) for x in v]
    return str(v)


class RequestTrace:
    """Thread-safe lifecycle timeline for ONE serve request."""

    __slots__ = ("id", "clock", "tenant", "grid", "bucket", "op", "flight",
                 "_events", "_lock")

    def __init__(self, id=None, *, clock=time.monotonic, tenant=None,
                 op=None, flight=None):
        self.id = id
        self.clock = clock
        self.tenant = tenant
        self.op = op
        self.grid = None
        self.bucket = None
        self.flight = flight
        self._events: list = []
        self._lock = threading.Lock()

    # ---- attribution -------------------------------------------------
    def annotate(self, **attrs) -> None:
        """Set identity/attribution fields as they become known
        (``id``/``tenant``/``grid``/``bucket``/``op``); None is a no-op
        so call sites can pass what they have unconditionally."""
        for k in ("id", "tenant", "grid", "bucket", "op"):
            v = attrs.get(k)
            if v is not None:
                setattr(self, k, v)

    # ---- marking -----------------------------------------------------
    def mark(self, edge: str, **attrs) -> float:
        """Timestamp ``edge`` now (injected clock); mirrors the event to
        the attached flight recorder and the active tracer's flow."""
        edge = str(edge)
        t = float(self.clock())
        rec = {k: v for k, v in attrs.items() if v is not None}
        with self._lock:
            self._events.append((edge, t, rec))
        # attribution fields first, the mark's own attrs win on collision
        mirror = {"id": self.id, "tenant": self.tenant, "grid": self.grid}
        mirror.update(rec)
        fl = self.flight
        if fl is not None:
            fl.record("edge:" + edge, **mirror)
        tr = _tracer.active_tracer()
        if tr is not None:
            mirror.pop("id", None)
            tr.instant("lifecycle:" + edge, flow=self.id, **mirror)
        return t

    # ---- reads -------------------------------------------------------
    def edges(self) -> list:
        """Snapshot [(edge, t, attrs), ...] in mark order."""
        with self._lock:
            return list(self._events)

    def edge_t(self, edge: str):
        """Timestamp of the LAST crossing of ``edge`` (None if never)."""
        with self._lock:
            for e, t, _ in reversed(self._events):
                if e == edge:
                    return t
        return None

    def to_doc(self) -> dict:
        """The stable ``serve_timeline/v1`` sub-document."""
        with self._lock:
            evs = list(self._events)
        t0 = evs[0][1] if evs else 0.0
        bucket = self.bucket
        if hasattr(bucket, "key"):
            bucket = list(bucket.key())
        rows = []
        for edge, t, attrs in evs:
            row = {"edge": edge, "t": t, "dt": t - t0}
            for k, v in attrs.items():
                row[str(k)] = _json_safe(v)
            rows.append(row)
        return {"schema": SCHEMA, "id": self.id,
                "tenant": self.tenant, "grid": self.grid,
                "bucket": _json_safe(bucket), "op": self.op,
                "t0": t0, "edges": rows}


def check_timeline(timeline, *, path=None, fleet: bool = False) -> list:
    """Validate a ``serve_timeline/v1`` sub-doc; returns a list of
    problem strings (empty = complete and monotone).

    ``path`` is the result doc's ``"path"`` ("fastpath" requires the
    stage/dispatch/collect/certify edges, "escalated"/"grid" the
    escalation edge); ``fleet=True`` additionally requires the
    tenant-queue edge.
    """
    if not isinstance(timeline, dict) or timeline.get("schema") != SCHEMA:
        return [f"missing or mis-schemaed timeline: {timeline!r:.80}"]
    rows = timeline.get("edges") or []
    edges = [r.get("edge") for r in rows]
    ts = [r.get("t") for r in rows]
    if not edges:
        return ["timeline has no edges"]
    problems = []
    if edges[0] != "submitted":
        problems.append(f"first edge is {edges[0]!r}, not 'submitted'")
    if edges[-1] not in ("done", "rejected"):
        problems.append(f"terminal edge is {edges[-1]!r}")
    if any(b < a for a, b in zip(ts, ts[1:])):
        problems.append("timestamps not monotone")
    if edges[-1] == "rejected":
        if "shed" not in edges:
            problems.append("rejected without a 'shed' edge")
        return problems
    for e in REQUIRED_OK:
        if e not in edges:
            problems.append(f"missing required edge {e!r}")
    if fleet and "tenant_queued" not in edges:
        problems.append("fleet timeline missing 'tenant_queued'")
    if path == "fastpath":
        for e in BATCH_EDGES:
            if e not in edges:
                problems.append(f"fastpath missing edge {e!r}")
    elif path in ("escalated", "grid") and "escalated" not in edges:
        problems.append(f"{path} path missing 'escalated' edge")
    return problems
