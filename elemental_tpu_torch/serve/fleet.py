"""Solver fleet: a pool of independent solver grids behind one front
door.

PyTorch port of ``elemental_tpu/serve/fleet.py``.  One
:class:`~.service.SolverService` owns ONE grid; past a few hosts that is
the wrong shape for serving -- dense-solve scaling flattens (the source
paper's weak-scaling curves) while request throughput keeps growing
linearly with devices.  The fleet takes the other axis: **partition**
the rank set into several SMALL grids, give each its own full serve
stack, and put a tenant-aware router in front::

    submit --> quota gate --> FairScheduler (per-tenant DRR queues)
                                  |
                              router: argmin over grids of
                                ceil((backlog+1)/max_batch)
                                  x per-grid EWMA batch seconds
                              (skip OPEN breakers + memory-shedding)
                                  |
               +------------------+------------------+
               v                  v                  v
           grid g0            grid g1            grid g2
        SolverService      SolverService      SolverService
        own executor       own executor       own executor
        cache, breaker,    cache, breaker,    cache, breaker,
        tuner ns, EWMA     tuner ns, EWMA     tuner ns, EWMA

On one card the ranks are the VIRTUAL grid's: a fleet partitions a list
of :class:`RankSlot` s (eight on the default grid's device unless the
caller passes its own), and each member gets a port :class:`Grid` of
the shape the JAX package's ``Grid`` gives the same rank count, on the
slots' device, with its own executor stream.  Members then share one
card: they overlap each other's host work, not their device time.

Each member is a COMPLETE, unmodified serve stack: its executor cache
captures its own entries (named after its lead rank slot) on its own
stream, its circuit breakers trip and
probe independently, its tuner constants live under its own cache
namespace (``tune_ns='g0'`` -- two members can hold DIFFERENT measured
winners for the same bucket), and its admission EWMA measures only its
own batches.  A fleet of one with no tenants is the plain
:class:`~.service.SolverService`.

Routing is load x speed: a request's bucket is known BEFORE a grid is
chosen (``validate_problem``), so the router scores every member by the
batches queued ahead of the request times that member's measured EWMA
for the bucket -- a slow or busy grid loses traffic to a fast idle one,
and the estimate converges per member as batches complete.  Members
whose breaker is OPEN for the bucket (cooldown not elapsed) or whose
per-device memory budget cannot hold the bucket are skipped; when NO
member can take it the reject is structured (``breaker_open`` /
``memory_pressure``, with the blocking grid's id).

Fairness is the :class:`~.scheduler.FairScheduler`'s deficit round
robin plus per-tenant ``max_outstanding`` quotas -- the quota reject
(``reason='quota'``) fires at submit, before anything queues.  Requests
are released to members only as capacity frees (``max_batch x depth``
outstanding per member), so a burst tenant queues in ITS OWN lane
instead of ahead of everyone in a member's FIFO.

Two execution modes:

  * ``pipelined=True`` (default): each member is wrapped in a depth-k
    :class:`~.async_front.AsyncSolverService` worker -- one thread per
    grid, all grids solving concurrently, completions streaming.
  * ``pipelined=False``: members stay synchronous and :meth:`drain`
    round-robins one batch per grid per sweep -- single-threaded and
    deterministic under injected clocks (the chaos-cell mode).

Every submit returns a :class:`FleetFuture` (a
:class:`~.async_front.ServeFuture` that also carries the fleet id,
tenant, and routed grid); result/reject docs carry ``grid`` and
``tenant`` fields (``serve_result/v1`` / ``serve_reject/v1``, absent ==
None for old readers).  Zero silent drops: every future issued resolves,
through results, structured rejects, or shutdown flushes.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import threading
import time

import torch

from ..core.grid import Grid, default_grid
from ..obs import metrics as _metrics
from ..obs.flight import FlightRecorder
from ..obs.lifecycle import RequestTrace
from ..obs.slo import SLOMonitor
from ..obs.tracer import phase_hook
from .admission import Deadline, reject_doc, validate_problem
from .async_front import AsyncSolverService, ServeFuture
from .policy import OPEN
from .scheduler import DEFAULT_TENANT, FairScheduler
from .service import SolverService


#: rank slots of the virtual grid a fleet partitions by default: the
#: JAX package's test mesh of eight virtual devices, so that ``grids=2``
#: gives two 2x2 members on one card as it does there
VIRTUAL_RANKS = 8


@dataclasses.dataclass(frozen=True)
class RankSlot:
    """One rank of the virtual grid a fleet partitions: ``id`` plays the
    JAX device id (it names the member's entries, ``__d{id}``) and
    ``device`` is the torch device the rank lives on."""
    id: int
    device: torch.device


def _fleet_device_order() -> list:
    """All rank slots, ordered so CONSECUTIVE slices are good grids.

    :data:`VIRTUAL_RANKS` slots on the default grid's device, in id
    order.  The port runs in one process on one device, so there is no
    multi-host ordering to make (the JAX package orders a multi-host
    device set by its hybrid ICI/DCN mesh here)."""
    dev = default_grid().device
    return [RankSlot(i, dev) for i in range(VIRTUAL_RANKS)]


def _grid_shape(p: int) -> tuple:
    """The (height, width) the JAX ``Grid(devices)`` gives ``p`` devices:
    the near-square height, the largest divisor of p at most sqrt(p)."""
    r = max(math.isqrt(p), 1)
    while p % r:
        r -= 1
    return r, p // r


def partition_devices(devices=None, grids=2) -> list:
    """Split the rank slots into per-member slot tuples.

    ``grids`` is an int (equal split; must divide the device count) or a
    sequence of sizes (must sum to at most the device count; leftovers
    stay unused).  Slices are consecutive in fleet device order, so each
    member's devices are as tightly coupled as the topology allows.
    ``devices=None`` takes :func:`_fleet_device_order`'s slots."""
    devices = list(_fleet_device_order() if devices is None else devices)
    p = len(devices)
    if isinstance(grids, int):
        g = max(int(grids), 1)
        if p % g != 0:
            raise ValueError(
                f"{g} equal grids do not divide {p} devices; pass "
                f"explicit sizes instead")
        sizes = [p // g] * g
    else:
        sizes = [int(s) for s in grids]
        if any(s < 1 for s in sizes):
            raise ValueError(f"grid sizes must be >= 1, got {sizes}")
        if sum(sizes) > p:
            raise ValueError(
                f"grid sizes {sizes} need {sum(sizes)} devices, "
                f"have {p}")
    out, at = [], 0
    for s in sizes:
        out.append(tuple(devices[at:at + s]))
        at += s
    return out


class FleetFuture(ServeFuture):
    """One fleet completion: a :class:`ServeFuture` plus routing
    provenance -- ``fleet_id`` (fleet-global, unlike per-member request
    ids, which collide across members), ``tenant``, and ``grid`` (the
    member name once routed, None if rejected before routing)."""

    __slots__ = ("fleet_id", "tenant", "grid", "t0")

    def __init__(self, fleet_id: int, tenant: str):
        super().__init__()
        self.fleet_id = fleet_id
        self.tenant = tenant
        self.grid: str | None = None
        self.t0: float | None = None     # fleet submit time (fleet clock)


class _FleetSub:
    """One scheduled submission (held in the FairScheduler until a
    member has capacity)."""

    __slots__ = ("op", "A", "B", "bucket", "deadline", "future", "trace")

    def __init__(self, op, A, B, bucket, deadline, future, trace=None):
        self.op, self.A, self.B = op, A, B
        self.bucket, self.deadline, self.future = bucket, deadline, future
        self.trace = trace


class GridWorker(AsyncSolverService):
    """A fleet member's depth-k async worker (thin naming/introspection
    shell over :class:`AsyncSolverService`)."""

    @property
    def name(self) -> str:
        return self.service.name

    def backlog_requests(self) -> int:
        """Requests inside this worker not yet settled (ingest queue +
        unresolved futures) -- introspection only; the fleet's routing
        backlog is its own lock-consistent counter."""
        return self._qin.qsize() + len(self._futures)


class SolverFleet:
    """See module docstring.

    ``devices=None`` partitions the default grid's
    :data:`VIRTUAL_RANKS` rank slots into ``grids`` members (int or
    explicit sizes, :func:`partition_devices`; pass a list of
    :class:`RankSlot` s to choose them);
    ``quotas`` maps tenant -> :class:`~.scheduler.TenantQuota` (or
    kwargs dict).  ``depth`` is each member's pipeline depth;
    ``pipelined=False`` keeps members synchronous (drive with
    :meth:`drain` -- the deterministic chaos mode).  Remaining
    ``**core_kw`` (max_batch, shed, breaker_threshold, retries,
    hbm_bytes, ...) go to every member's :class:`SolverService`."""

    def __init__(self, devices=None, *, grids=2, depth: int = 3,
                 quotas: dict | None = None, pipelined: bool = True,
                 autostart: bool = True, clock=time.monotonic,
                 sleep=None, flight=None, slo=None, **core_kw):
        parts = partition_devices(devices, grids)
        self.pipelined = bool(pipelined)
        self.depth = max(int(depth), 1)
        self.clock = clock
        #: ONE flight recorder shared by every member: a
        #: breaker trip on g1 dumps the record of what g0 was doing too
        self.flight = flight if flight is not None \
            else FlightRecorder(clock=clock)
        #: windowed per-(tenant, grid, bucket) SLO estimators, fed by
        #: every settled doc
        self.slo = slo if slo is not None else SLOMonitor()
        self.scheduler = FairScheduler(quotas=quotas)
        self.services: list = []         # per-member SolverService cores
        self.workers: list = []          # pipelined mode: GridWorker per core
        for i, devs in enumerate(parts):
            name = f"g{i}"
            svc = SolverService(
                Grid(*_grid_shape(len(devs)), device=devs[0].device),
                name=name, tune_ns=name,
                pipeline_depth=self.depth, device=devs[0],
                clock=clock, sleep=sleep, flight=self.flight, **core_kw)
            self.services.append(svc)
            if self.pipelined:
                self.workers.append(GridWorker(
                    service=svc, depth=self.depth, autostart=autostart))
            else:
                svc.on_result = self._make_on_result(i)
        self.max_batch = self.services[0].max_batch
        #: outstanding per member counts ROUTED, unsettled requests; a
        #: member accepts at most ``max_batch x depth`` (pipelined) or
        #: ``max_batch`` (sync) before the scheduler holds the rest
        self._grid_cap = self.max_batch * (self.depth if self.pipelined
                                           else 1)
        self._grid_out = [0] * len(self.services)
        self._tenant_out: dict = {}      # tenant -> unsettled count
        self._pending: list = [dict() for _ in self.services]  # sync mode
        self._ids = itertools.count()
        self.results: dict = {}          # fleet_id -> final doc
        self._settled: list = []         # (fleet_id, doc) ledger, in order
        self._stop = False
        # RLock: future resolution (inside _pump, under the lock) fires
        # the accounting callback, which re-enters _pump
        self._lock = threading.RLock()

    # ---- member plumbing --------------------------------------------
    def _make_on_result(self, gi: int):
        def on_result(rid, doc, x):
            self._grid_settled(gi, rid, doc, x)
        return on_result

    def _grid_settled(self, gi: int, rid, doc, x) -> None:
        """Sync-mode member completion: map the member's request id back
        to its fleet future and settle it."""
        with self._lock:
            fut = self._pending[gi].pop(rid, None)
            self._grid_out[gi] = max(self._grid_out[gi] - 1, 0)
        if fut is not None:
            self._settle(fut, doc, x)

    def _settle(self, fut: FleetFuture, doc, x) -> None:
        if isinstance(doc, dict) and "latency_s" in doc \
                and fut.t0 is not None:
            # the member measured from ITS arrival; the tenant waited
            # from fleet submit, scheduler hold included -- re-stamp on
            # a copy so the member's own ledger keeps its view
            doc = dict(doc)
            doc["latency_s"] = self.clock() - fut.t0
        with self._lock:
            self.results[fut.fleet_id] = doc
            self._settled.append((fut.fleet_id, doc))
            if isinstance(doc, dict):    # windowed SLO feed
                self.slo.record(doc)
        fut._resolve(doc, x)

    def _account(self, fut) -> None:
        """Done-callback on every issued future: release the tenant's
        quota slot and pump held work into the freed capacity."""
        with self._lock:
            t = fut.tenant
            self._tenant_out[t] = max(self._tenant_out.get(t, 0) - 1, 0)
        self._pump()

    # ---- submit ------------------------------------------------------
    def submit(self, op: str, A, B, *, budget_s: float | None = None,
               deadline: Deadline | None = None,
               tenant: str | None = None, callback=None) -> FleetFuture:
        """Enqueue one request; returns its :class:`FleetFuture`.

        The deadline clock starts HERE.  Rejections (quota, shutdown,
        bad request, no capable grid, member-level sheds) resolve the
        future with a structured ``serve_reject/v1`` -- nothing raises.
        ``tenant=None`` bills the shared ``'default'`` tenant."""
        tenant = DEFAULT_TENANT if tenant is None else str(tenant)
        fut = FleetFuture(next(self._ids), tenant)
        fut.t0 = self.clock()
        # fleet-global id keys the lifecycle flow: member request ids
        # collide across grids, fleet ids never do
        trace = RequestTrace(id=f"f{fut.fleet_id}", clock=self.clock,
                             tenant=tenant, op=op, flight=self.flight)
        trace.mark("submitted", op=op)
        if callback is not None:
            fut.add_done_callback(callback)
        if deadline is None and budget_s is not None:
            deadline = Deadline(budget_s, clock=self.clock)
        if self._stop:
            _metrics.inc("serve_rejects", reason="shutdown")
            self.flight.record("reject", reason="shutdown", tenant=tenant)
            self._settle(fut, reject_doc(
                "shutdown", deadline=deadline, tenant=tenant,
                detail="fleet has shut down", trace=trace), None)
            return fut
        v = validate_problem(op, A, B)
        if isinstance(v, dict):
            v["tenant"] = tenant
            _metrics.inc("serve_rejects", reason=v["reason"])
            self.flight.record("reject", reason=v["reason"], tenant=tenant)
            trace.mark("shed", reason=v["reason"])
            trace.mark("rejected")
            v["timeline"] = trace.to_doc()
            self._settle(fut, v, None)
            return fut
        op, A, B, bucket = v
        with self._lock:
            q = self.scheduler.quota(tenant)
            if q.max_outstanding is not None \
                    and self._tenant_out.get(tenant, 0) >= q.max_outstanding:
                _metrics.inc("serve_rejects", reason="quota")
                # kind='reject' reason='quota' is what arms the flight
                # recorder's quota-storm trigger
                self.flight.record("reject", reason="quota", tenant=tenant)
                self._settle(fut, reject_doc(
                    "quota", bucket=bucket,
                    queue_depth=self.scheduler.pending(tenant),
                    deadline=deadline, tenant=tenant,
                    detail=f"tenant {tenant!r} at max_outstanding="
                           f"{q.max_outstanding}", trace=trace), None)
                return fut
            self._tenant_out[tenant] = self._tenant_out.get(tenant, 0) + 1
            fut.add_done_callback(self._account)
            self.scheduler.push(
                tenant, _FleetSub(op, A, B, bucket, deadline, fut, trace),
                cost=bucket.solve_flops())
        self._pump()
        return fut

    # ---- routing -----------------------------------------------------
    def _blocked(self, gi: int, bucket) -> str | None:
        """Why member ``gi`` cannot take ``bucket`` right now: 'memory'
        (static peak over its HBM budget), 'breaker' (OPEN, cooldown not
        elapsed -- the same peek-only check as ``SolverService.submit``),
        or None when capable."""
        svc = self.services[gi]
        if svc.admission.memory_pressure(bucket) is not None:
            return "memory"
        br = svc.breakers.get(bucket.key())
        if br is not None and br.state == OPEN:
            elapsed_ok = br.opened_at is not None \
                and svc.clock() - br.opened_at >= br.cooldown_s
            if not elapsed_ok:
                return "breaker"
        return None

    def _score(self, gi: int, bucket) -> tuple:
        """Routing score (lower wins): queued batches ahead x the
        member's measured EWMA for the bucket, tie-broken by raw backlog
        then member index (deterministic, and backlog ties alternate)."""
        out = self._grid_out[gi]
        batches = -(-(out + 1) // self.max_batch)
        est = self.services[gi].admission.estimate_batch_s(bucket)
        return (batches * est, out, gi)

    def _route_one(self, sub: _FleetSub):
        """Pick a member for one scheduled submission.  Returns the
        member index, a reject doc (no member can EVER take it right
        now), or None (capable members exist but all are at capacity --
        caller re-queues and waits for a completion)."""
        blocked: list = []
        best = None
        capable = False
        for gi in range(len(self.services)):
            why = self._blocked(gi, sub.bucket)
            if why is not None:
                blocked.append((gi, why))
                continue
            capable = True
            if self._grid_out[gi] >= self._grid_cap:
                continue
            s = self._score(gi, sub.bucket)
            if best is None or s < best[0]:
                best = (s, gi)
        if best is not None:
            return best[1]
        if capable:
            return None                  # all capable members full: hold
        # nobody can take this bucket: structured reject, attributed to
        # the first blocking member (memory wins when uniform)
        reasons = {why for _, why in blocked}
        reason = "memory_pressure" if reasons == {"memory"} \
            else "breaker_open"
        gi, why = blocked[0]
        _metrics.inc("serve_rejects", reason=reason)
        self.flight.record("reject", reason=reason,
                           tenant=sub.future.tenant,
                           bucket=sub.bucket.key())
        return reject_doc(
            reason, bucket=sub.bucket, deadline=sub.deadline,
            grid=self.services[gi].name, tenant=sub.future.tenant,
            detail=f"no fleet member can take {sub.bucket.key()}: "
                   + ", ".join(f"{self.services[g].name}={w}"
                               for g, w in blocked),
            trace=sub.trace)

    def _pump(self) -> int:
        """Release scheduled work into member capacity, fairest first.
        Returns how many submissions were routed or rejected."""
        moved = 0
        with self._lock:
            while self.scheduler.pending() > 0:
                if all(o >= self._grid_cap for o in self._grid_out):
                    break
                sub = self.scheduler.pop()
                routed = self._route_one(sub)
                if routed is None:       # capable members all full
                    self.scheduler.push_front(
                        sub.future.tenant, sub,
                        cost=sub.bucket.solve_flops())
                    break
                moved += 1
                if isinstance(routed, dict):
                    self._settle(sub.future, routed, None)
                    continue
                self._dispatch(routed, sub)
            _metrics.set_gauge("serve_fleet_pending",
                               self.scheduler.pending())
            for gi, svc in enumerate(self.services):
                _metrics.set_gauge("serve_grid_outstanding",
                                   self._grid_out[gi], grid=svc.name)
        return moved

    def _dispatch(self, gi: int, sub: _FleetSub) -> None:
        """Hand one submission to member ``gi`` (lock held)."""
        svc = self.services[gi]
        sub.future.grid = svc.name
        if sub.trace is not None:
            sub.trace.annotate(grid=svc.name)
        self._grid_out[gi] += 1
        if self.pipelined:
            fut = sub.future

            def chain(inner, gi=gi, fut=fut):
                with self._lock:
                    self._grid_out[gi] = max(self._grid_out[gi] - 1, 0)
                self._settle(fut, inner._doc, inner._x)

            self.workers[gi].submit(
                sub.op, sub.A, sub.B, deadline=sub.deadline,
                tenant=fut.tenant, callback=chain, trace=sub.trace)
            return
        out = svc.submit(sub.op, sub.A, sub.B, deadline=sub.deadline,
                         tenant=sub.future.tenant, trace=sub.trace)
        if isinstance(out, dict):        # member-level fast reject
            self._grid_out[gi] = max(self._grid_out[gi] - 1, 0)
            self._settle(sub.future, out, None)
        else:
            self._pending[gi][out] = sub.future

    # ---- sync drive (chaos / deterministic mode) ---------------------
    def drain(self) -> dict:
        """Sync mode only: process everything scheduled + queued.  One
        batch per member per sweep (members take turns, so one member's
        deep queue cannot monopolize the host), pumping freed capacity
        between sweeps.  Returns ``{fleet_id: doc}`` settled by this
        call."""
        if self.pipelined:
            raise RuntimeError("drain() drives pipelined=False fleets; "
                               "pipelined members run their own workers")
        tm = phase_hook("serve")
        tm.start()
        n0 = len(self._settled)
        bi = 0
        while True:
            moved = self._pump()
            ran = False
            for svc in self.services:
                popped = svc._pop_batch()
                if popped is None:
                    continue
                bucket, batch = popped
                svc._run_batch(bucket, batch, tm, bi)
                bi += 1
                ran = True
            if not ran and moved == 0:
                break
        return dict(self._settled[n0:])

    # ---- lifecycle ---------------------------------------------------
    def shutdown(self, drain: bool = True) -> dict:
        """Stop the fleet.  ``drain=True`` finishes everything scheduled
        and queued through the normal pipeline; ``drain=False`` flushes
        scheduled work with structured shutdown rejects and emergency-
        stops every member (their in-flight batches still complete).
        Every outstanding future resolves either way -- zero silent
        drops.  Idempotent.  Returns ``{fleet_id: doc}`` for everything
        settled by this call."""
        n0 = len(self._settled)
        with self._lock:
            already = self._stop
            self._stop = True
        if drain and not already:
            if self.pipelined:
                # held submissions release as member completions free
                # capacity; poll until the scheduler empties
                while True:
                    self._pump()
                    with self._lock:
                        if self.scheduler.pending() == 0:
                            break
                    time.sleep(0.002)
                for w in self.workers:
                    w.shutdown(drain=True)
            else:
                self.drain()
                for svc in self.services:
                    svc.shutdown(drain=True)
        else:
            with self._lock:
                held = self.scheduler.flush()
            for sub in held:
                _metrics.inc("serve_rejects", reason="shutdown")
                self.flight.record("reject", reason="shutdown",
                                   tenant=sub.future.tenant)
                self._settle(sub.future, reject_doc(
                    "shutdown", bucket=sub.bucket, deadline=sub.deadline,
                    tenant=sub.future.tenant,
                    detail="flushed by fleet shutdown(drain=False)",
                    trace=sub.trace), None)
            if self.pipelined:
                for w in self.workers:
                    w.shutdown(drain=False)
            else:
                for svc in self.services:
                    svc.shutdown(drain=False)
        return dict(self._settled[n0:])

    # ---- introspection ----------------------------------------------
    def stats(self) -> dict:
        """One structured snapshot: per-member identity/backlog/EWMA,
        scheduler queues and deficits, tenant outstanding counts."""
        with self._lock:
            members = []
            for gi, svc in enumerate(self.services):
                members.append({
                    "grid": svc.name, "devices": svc.grid.size,
                    "shape": [svc.grid.height, svc.grid.width],
                    "outstanding": self._grid_out[gi],
                    "capacity": self._grid_cap,
                    "queued": svc.queue_depth(),
                    "ewma_s": dict(svc.admission._ewma),
                    "breakers": {k: b.state
                                 for k, b in svc.breakers.items()},
                })
            return {"members": members,
                    "scheduler": self.scheduler.to_doc(),
                    "tenants_outstanding": dict(self._tenant_out),
                    "pipelined": self.pipelined, "depth": self.depth}
