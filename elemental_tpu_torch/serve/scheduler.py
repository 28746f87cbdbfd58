"""Tenant-aware fair scheduling: quotas + deficit round robin.

PyTorch port of ``elemental_tpu/serve/scheduler.py`` (host-only).  The
fleet's front queue.  A single FIFO lets one tenant's burst starve
everyone behind it; the :class:`FairScheduler` instead keeps ONE queue
per tenant and serves them by **deficit round robin** (DRR): each visit
tops a tenant's deficit counter up by ``quantum x share`` and dequeues
work while the deficit covers the head item's cost, so over any window
every backlogged tenant drains in proportion to its configured share --
a 40-request burst from one tenant cannot push another tenant's single
request more than one round back.  Costs default to the bucket's
padded solve flops (a 512-system counts more than a 32-system), so
fairness is in COMPUTE, not request count.

Quotas are the other half (:class:`TenantQuota`): ``max_outstanding``
caps how many of a tenant's requests may be unresolved at once --
enforcement lives in the fleet's submit path, which issues the
schema-pinned ``serve_reject/v1`` ``reason='quota'`` BEFORE anything is
queued (the reject-fast contract admission established for shedding).

Determinism: tenants are visited in first-arrival order, the round
cursor is plain state, and nothing reads a wall clock -- a replayed
submission sequence pops in an identical order, which is what lets the
fairness tests pin latency bounds under injected clocks.

Observability: ``serve_tenant_queue_depth`` and ``serve_tenant_deficit``
gauges per tenant, ``serve_tenant_enqueued`` counters.
"""
from __future__ import annotations

import collections
import dataclasses

from ..obs import metrics as _metrics

#: tenant used when a caller never names one
DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """One tenant's scheduling contract.

    ``share`` is the DRR weight (relative drain rate among backlogged
    tenants); ``max_outstanding`` caps unresolved requests (None =
    unlimited) -- exceeding it draws a ``'quota'`` reject at submit."""
    share: float = 1.0
    max_outstanding: int | None = None

    def __post_init__(self):
        if not (self.share > 0.0):
            raise ValueError(f"tenant share must be > 0, got {self.share}")
        if self.max_outstanding is not None and self.max_outstanding < 1:
            raise ValueError("max_outstanding must be >= 1 or None")


class FairScheduler:
    """Deficit-round-robin fair queue over per-tenant FIFOs.

    ``push(tenant, item, cost)`` enqueues; ``pop()`` returns the next
    item under DRR or None when empty.  A tenant keeps the turn while
    its deficit covers its queue head (classic DRR serves a full
    quantum per visit), then the cursor advances.  ``quantum=None``
    (default) auto-sizes each top-up to the largest head cost among
    backlogged tenants, the standard choice that guarantees every visit
    can afford at least one item regardless of cost scale."""

    def __init__(self, *, quotas: dict | None = None,
                 default_share: float = 1.0,
                 quantum: float | None = None):
        self.quotas = {str(t): q if isinstance(q, TenantQuota)
                       else TenantQuota(**dict(q))
                       for t, q in (quotas or {}).items()}
        self.default_share = float(default_share)
        self.quantum = None if quantum is None else float(quantum)
        self._queues: dict = {}          # tenant -> deque[(item, cost)]
        self._deficit: dict = {}         # tenant -> float
        self._order: list = []           # first-arrival tenant order
        self._cursor = 0                 # index into _order
        self._topped = False             # cursor position got its top-up

    # ---- quota lookup ------------------------------------------------
    def quota(self, tenant: str) -> TenantQuota:
        q = self.quotas.get(tenant)
        if q is None:
            q = TenantQuota(share=self.default_share)
        return q

    def share(self, tenant: str) -> float:
        return self.quota(tenant).share

    # ---- queue ops ---------------------------------------------------
    def push(self, tenant: str, item, cost: float = 1.0) -> None:
        tenant = str(tenant)
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = collections.deque()
            self._deficit[tenant] = 0.0
            self._order.append(tenant)
        q.append((item, max(float(cost), 1e-30)))
        tr = getattr(item, "trace", None)
        if tr is not None:                       # lifecycle edge
            tr.mark("tenant_queued", tenant=tenant, depth=len(q))
        _metrics.inc("serve_tenant_enqueued", tenant=tenant)
        _metrics.set_gauge("serve_tenant_queue_depth", len(q),
                           tenant=tenant)

    def push_front(self, tenant: str, item, cost: float = 1.0) -> None:
        """Router un-pop: re-queue ``item`` at the HEAD of its tenant's
        queue and refund the deficit :meth:`pop` spent on it.  The fleet
        uses this when every member capable of the item's bucket is at
        capacity -- the item must wait without losing its turn."""
        tenant = str(tenant)
        c = max(float(cost), 1e-30)
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = collections.deque()
            self._deficit[tenant] = 0.0
            self._order.append(tenant)
        q.appendleft((item, c))
        self._deficit[tenant] += c
        _metrics.set_gauge("serve_tenant_queue_depth", len(q),
                           tenant=tenant)

    def pending(self, tenant: str | None = None) -> int:
        if tenant is not None:
            return len(self._queues.get(str(tenant), ()))
        return sum(len(q) for q in self._queues.values())

    def _quantum(self) -> float:
        if self.quantum is not None:
            return self.quantum
        heads = [q[0][1] for q in self._queues.values() if q]
        return max(heads) if heads else 1.0

    def _advance(self) -> None:
        self._cursor += 1
        self._topped = False

    def pop(self):
        """The next item under DRR, or None when nothing is queued.

        A tenant's deficit tops up once per VISIT -- the first time the
        cursor lands on it, not once per pop -- so a tenant keeps the
        turn only while already-granted credit covers its heads, then
        yields.  (Topping up per pop would refill the same tenant
        forever under uniform costs: the exact starvation DRR exists to
        prevent.)

        Termination: every full sweep over backlogged tenants tops each
        deficit up by ``quantum x share > 0`` and the affordable head
        cost is finite, so some tenant becomes servable after finitely
        many sweeps (one, with the auto quantum and shares >= 1)."""
        if self.pending() == 0:
            return None
        n = len(self._order)
        visited_since_serve = 0
        while True:
            tenant = self._order[self._cursor % n]
            q = self._queues[tenant]
            if not q:
                self._deficit[tenant] = 0.0      # classic DRR reset
                self._advance()
                continue
            item, cost = q[0]
            if not self._topped and self._deficit[tenant] < cost:
                self._deficit[tenant] += self._quantum() \
                    * self.share(tenant)
                self._topped = True
            if self._deficit[tenant] < cost:
                visited_since_serve += 1
                if visited_since_serve > 4 * n + 4:
                    # cost scale outran the quantum (small shares or
                    # fixed-quantum configs): serve the head anyway
                    # rather than spin -- progress beats exactness
                    self._deficit[tenant] = cost
                else:
                    self._advance()
                    continue
            q.popleft()
            self._deficit[tenant] -= cost
            if not q:
                self._deficit[tenant] = 0.0      # empty queue: no credit
                self._advance()                  # give up the turn
            tr = getattr(item, "trace", None)
            if tr is not None:                   # queue-wait
                t_q = tr.edge_t("tenant_queued")
                if t_q is not None:
                    _metrics.observe("serve_queue_wait_seconds",
                                     tr.clock() - t_q, tenant=tenant)
            _metrics.set_gauge("serve_tenant_queue_depth", len(q),
                               tenant=tenant)
            _metrics.set_gauge("serve_tenant_deficit",
                               self._deficit[tenant], tenant=tenant)
            return item

    def flush(self) -> list:
        """Drain EVERYTHING (shutdown path): all queued items in tenant
        arrival order, FIFO within each tenant.  Resets all deficits."""
        out = []
        self._topped = False
        for tenant in self._order:
            q = self._queues[tenant]
            while q:
                out.append(q.popleft()[0])
            self._deficit[tenant] = 0.0
            _metrics.set_gauge("serve_tenant_queue_depth", 0,
                               tenant=tenant)
        return out

    def to_doc(self) -> dict:
        """Introspection snapshot (what the fleet's stats report)."""
        return {"tenants": list(self._order),
                "depths": {t: len(self._queues[t]) for t in self._order},
                "deficits": {t: self._deficit[t] for t in self._order},
                "shares": {t: self.share(t) for t in self._order}}
