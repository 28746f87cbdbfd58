"""Chaos harness: the serve acceptance matrix under fault injection.

PyTorch port of ``elemental_tpu/serve/chaos.py``.  Drives a
:class:`~.service.SolverService` against the
:class:`~elemental_tpu_torch.resilience.FaultPlan` machinery (seeded,
bit-identically replayable) and CLASSIFIES every request's outcome, so
the acceptance matrix

    {bitflip, scale, nan} x {redistribute, compute} x {oneshot, persistent}

is pinned as data: every fault is either

  * **absorbed**  -- the request still ended ``ok`` within its deadline
    (bisect re-execution ate a one-shot fault, or escalation repaired
    it), with the independently recomputed residual under tol;
  * **isolated**  -- the faulted request failed/timed out ALONE while
    its batch-mates ended ``ok`` (zero collateral damage);
  * **surfaced**  -- a structured failure (certificate with failing
    phase / timed_out flag), never a silent garbage solution.

Violations -- silent garbage (``ok`` whose trusted recomputed residual
exceeds tol), collateral damage (a non-faulted batch-mate not ``ok`` in
a one-shot cell), or an unstructured failure -- are collected per cell;
a clean matrix has none.  ``python -m elemental_tpu_torch.serve chaos``
is the CLI; the CPU tests hold each cell's outcome classes to the JAX
package's, plus replay determinism.

Fault-target routing: ``compute`` cells run the BATCHED fast path (the
executor's solve output crosses the compute seam -- call 0 is the first
batch); ``redistribute`` / ``panel_spread`` cells run ``fastpath=False``
so every request exercises the distributed certified path where the
engine seams live (the big-problem serving mode).

A ``qr`` op column (:func:`run_qr_cell`) drives the driver directly
under the same fault axes, as ``qr(..., abft=True, health=True)``:
detection rides the Huang-Abraham checksum checks, ALL THREE kinds gate
(bitflip included -- see :data:`QR_DETECTED_KINDS`), and each cell
additionally pins the recovery contract (one recomputed panel, clean
trusted residual).

An **async** column: :func:`run_async_cell` drives the
pipelined :class:`~.async_front.AsyncSolverService` with TWO batches in
flight so the fault lands mid-pipeline -- batch 0's device output is
corrupted while batch 1 is already staged/dispatched behind it -- and
pins that the damage never leaks into the neighbor batch.  The same
grading applies (the worker thread is deterministic: single consumer,
FIFO batch pop, so seeded plans replay).  :func:`run_async_shutdown_cell`
pins ``shutdown(drain=False)`` under load: every future resolves, every
unexecuted request gets a STRUCTURED ``serve_reject/v1`` shutdown
reject, zero silent drops.

A **fleet** column: :func:`run_fleet_saturation_cell`
drives a 2-grid sync fleet into overload under a virtual clock (batch
execution advances injected time, so deadline/shed dynamics are exact
and replayable) and pins that every shed is STRUCTURED and attributed
to its grid while admitted latency stays deadline-bounded and FLAT as
overload grows; :func:`run_fleet_grid_loss_cell` poisons one member's
executor until its breaker opens and pins that traffic RE-ROUTES to the
healthy member (every post-loss request served there, fastpath) with
zero silent drops and bit-identical replay.
"""
from __future__ import annotations

import json

import numpy as np

from ..resilience.faults import (FAULT_KINDS, FaultPlan, FaultSpec,
                                 logs_identical)
from ..redist.engine import fault_injection
from .admission import REJECT_REASONS, REJECT_SCHEMA
from .async_front import AsyncSolverService
from .executor import residual
from .service import SolverService

CHAOS_SCHEMA = "chaos_report/v1"

#: the matrix's default target axis (panel_spread is covered by the
#: resilience suite; serve adds the compute axis it introduced)
CHAOS_TARGETS = ("redistribute", "compute")
CHAOS_MODES = ("oneshot", "persistent")

#: ops whose serve path exercises each target (overridable per cell)
_OP_FOR_TARGET = {"redistribute": "lu", "panel_spread": "hpd",
                  "compute": "hpd"}


def build_workload(op: str, n: int, nrhs: int, count: int, seed: int,
                   dtype=None):
    """``count`` well-conditioned problems (same bucket), seeded.

    ``dtype=None`` adapts to the runtime: float64 when the default grid
    is on the CPU (the tests, as the JAX package's x64 harness), float32
    on the card.  The problems are numpy arrays drawn from ``seed``, the
    same ones the JAX package draws."""
    if dtype is None:
        from ..core.grid import default_grid
        dtype = np.float32 if default_grid().device.type == "cuda" \
            else np.float64
    dtype = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        F = rng.normal(size=(n, n))
        A = F @ F.T / n + n * np.eye(n) if op == "hpd" \
            else F + n * np.eye(n)
        B = rng.normal(size=(n, nrhs))
        out.append((A.astype(dtype), B.astype(dtype)))
    return out


def make_service(grid, *, fastpath: bool, requests: int,
                 clock=None, sleep=None, **kw) -> SolverService:
    """A chaos-shaped service: one batch holds the whole workload, no
    shedding, a breaker too patient to interfere with the cell (breaker
    dynamics have their own tests), near-zero backoff."""
    skw = dict(max_batch=max(requests, 1), capacity=4 * max(requests, 1),
               shed=False, fastpath=fastpath, breaker_threshold=99,
               retries=1, backoff_base_s=0.0)
    skw.update(kw)
    if clock is not None:
        skw["clock"] = clock
    if sleep is not None:
        skw["sleep"] = sleep
    return SolverService(grid, **skw)


def compute_slots(plan: FaultPlan, bucket_n: int, bucket_nrhs: int) -> set:
    """Batch slots whose payload a ``compute`` fault event on the FIRST
    batched dispatch touched (flat index -> leading batch axis)."""
    hit = set()
    per = bucket_n * bucket_nrhs
    for ev in plan.log:
        if ev.target == "compute" and len(ev.shape) == 3:
            hit.update(int(i) // per for i in np.asarray(ev.indices))
    return hit


def run_cell(grid, *, kind: str, target: str, mode: str,
             op: str | None = None, n: int = 16, nrhs: int = 2,
             requests: int = 4, call: int = 0, nelem: int = 2,
             seed: int = 13, budget_s: float | None = None,
             service_kw: dict | None = None):
    """One acceptance-matrix cell.  Returns ``(cell_doc, plan, service)``
    -- the plan so callers can replay-compare logs, the service so tests
    can poke solutions/metrics."""
    op = op or _OP_FOR_TARGET[target]
    fastpath = target == "compute"
    svc = make_service(grid, fastpath=fastpath, requests=requests,
                       **(service_kw or {}))
    workload = build_workload(op, n, nrhs, requests, seed)
    plan = FaultPlan(seed=seed, faults=[
        FaultSpec(target, kind, call=call, every=(mode == "persistent"),
                  nelem=nelem)])
    ids = []
    for A, B in workload:
        rid = svc.submit(op, A, B, budget_s=budget_s)
        assert not isinstance(rid, dict), f"chaos submit rejected: {rid}"
        ids.append(rid)
    with fault_injection(plan):
        svc.drain()
    return _classify(svc, plan, workload, ids, kind=kind, target=target,
                     mode=mode, op=op, budget_s=budget_s), plan, svc


def _classify(svc, plan, workload, ids, *, kind, target, mode, op,
              budget_s):
    outcomes = {}
    violations = []
    hit_slots = None
    if target == "compute" and mode == "oneshot" and plan.log:
        b = svc.results[ids[0]]["bucket"]        # all same bucket
        bn, brhs = (int(x) for x in
                    b.split("__b")[1].split("__")[0].split("x"))
        hit_slots = compute_slots(plan, bn, brhs)
    n_ok = 0
    for slot, (rid, (A, B)) in enumerate(zip(ids, workload)):
        doc = svc.results[rid]
        st = doc["status"]
        outcomes[rid] = st
        if st == "ok":
            n_ok += 1
            X = svc.solutions.get(rid)
            if X is None or residual(A, B, X) > doc["tol"]:
                violations.append({"kind": "silent_garbage", "id": rid,
                                   "detail": "ok result fails the trusted "
                                             "recomputed residual"})
        elif st == "failed":
            if doc["certificate"] is None:
                violations.append({"kind": "unstructured", "id": rid,
                                   "detail": "failed without certificate"})
        elif st == "timed_out":
            if not doc["timed_out"]:
                violations.append({"kind": "unstructured", "id": rid,
                                   "detail": "timed_out without flag"})
            cert = doc["certificate"]
            if cert is not None and not cert["timed_out"] \
                    and len(cert["attempts"]) >= len(cert["ladder"]):
                violations.append({
                    "kind": "overrun", "id": rid,
                    "detail": "full ladder ran past an expired deadline"})
        else:
            violations.append({"kind": "unstructured", "id": rid,
                               "detail": f"unexpected status {st!r}"})
        # zero collateral damage: in a one-shot compute cell, a request
        # whose batch slot the fault never touched must end ok
        if hit_slots is not None and slot not in hit_slots and st != "ok":
            violations.append({"kind": "collateral", "id": rid,
                               "detail": f"untouched slot {slot} not ok"})
    if mode == "oneshot" and len(ids) - n_ok > 1:
        violations.append({"kind": "collateral",
                           "detail": f"one-shot fault took down "
                                     f"{len(ids) - n_ok} requests"})
    verdict = "absorbed" if n_ok == len(ids) else \
        ("isolated" if n_ok >= len(ids) - 1 and mode == "oneshot"
         else "surfaced")
    return {"kind": kind, "target": target, "mode": mode, "op": op,
            "requests": len(ids), "ok": n_ok, "fired": plan.fired(),
            "budget_s": budget_s, "outcomes": outcomes,
            "verdict": verdict, "violations": violations}


def run_async_cell(grid, *, kind: str, mode: str, target: str = "compute",
                   op: str | None = None, n: int = 16, nrhs: int = 2,
                   requests: int = 8, call: int = 0, nelem: int = 2,
                   seed: int = 13, budget_s: float | None = None,
                   service_kw: dict | None = None):
    """One async-column cell: the fault lands MID-PIPELINE.

    ``requests`` split into two batches (``max_batch = requests // 2``)
    so that when batch 0's solve output crosses the compute seam
    (call 0), batch 1 is already staged and dispatched behind it on the
    device queue.  The front is built with ``autostart=False`` and the
    whole workload pre-loaded before the worker starts, which fixes
    batch membership -- the cell is deterministic and seeded plans
    replay.  Grading is the sync :func:`_classify` verbatim: a one-shot
    fault in batch 0 must leave every batch-1 (neighbor) request ``ok``
    -- anything else is ``collateral``.  Returns
    ``(cell_doc, plan, front)``."""
    op = op or _OP_FOR_TARGET[target]
    fastpath = target == "compute"
    batch = max(requests // 2, 1)
    svc = make_service(grid, fastpath=fastpath, requests=batch,
                       **(service_kw or {}))
    front = AsyncSolverService(svc, donate=True, autostart=False)
    workload = build_workload(op, n, nrhs, requests, seed)
    plan = FaultPlan(seed=seed, faults=[
        FaultSpec(target, kind, call=call, every=(mode == "persistent"),
                  nelem=nelem)])
    futs = [front.submit(op, A, B, budget_s=budget_s)
            for A, B in workload]
    with fault_injection(plan):
        front.start()
        front.shutdown(drain=True)
    ids = [f.id for f in futs]   # assigned at worker ingest; join'd now
    cell = _classify(svc, plan, workload, ids, kind=kind, target=target,
                     mode=mode, op=op, budget_s=budget_s)
    cell["column"] = "async"
    cell["batches"] = -(-requests // batch)
    for f in futs:
        if not f.done():                        # zero silent drops
            cell["violations"].append(
                {"kind": "silent_drop", "id": f.id,
                 "detail": "future never resolved through drain"})
    return cell, plan, front


def run_async_shutdown_cell(grid, *, n: int = 16, nrhs: int = 2,
                            requests: int = 12, seed: int = 13,
                            service_kw: dict | None = None):
    """``shutdown(drain=False)`` under load: structured flush, no drops.

    Three batches of work; a gate callback PARKS the worker inside
    batch 0's completion -- at which point batch 1 is already dispatched
    (double buffering stages k+1 before collecting k) and batch 2 still
    queued -- then hard-stops.  Deterministic pins: batch 0 and the
    in-flight batch 1 complete ``ok``; batch 2 flushes with structured
    ``serve_reject/v1`` ``reason="shutdown"`` rejects; every future
    resolves (zero silent drops); a post-shutdown submit rejects
    immediately.  Returns ``(cell_doc, front)``."""
    import threading
    batch = max(requests // 3, 1)
    svc = make_service(grid, fastpath=True, requests=batch,
                       **(service_kw or {}))
    front = AsyncSolverService(svc, donate=True, autostart=False)
    workload = build_workload("hpd", n, nrhs, requests, seed)
    futs = [front.submit("hpd", A, B) for A, B in workload]
    parked, go = threading.Event(), threading.Event()

    def _gate(_fut):                    # fires on the worker thread
        parked.set()
        go.wait(timeout=120.0)

    futs[0].add_done_callback(_gate)
    front.start()
    assert parked.wait(timeout=120.0), "worker never reached batch 0"
    # worker is parked mid-completion of batch 0; batch 1 is on device.
    # Flip the stop flags BEFORE releasing it so the very next loop
    # iteration takes the emergency-stop path (GIL makes the writes
    # visible); shutdown() is idempotent and just joins.
    front._stop, front._drain = True, False
    go.set()
    front.shutdown(drain=False)
    violations = []
    outcomes = {}
    n_ok = n_flush = 0
    for f, (A, B) in zip(futs, workload):
        if not f.done():
            violations.append({"kind": "silent_drop", "id": f.id,
                               "detail": "future unresolved after "
                                         "shutdown(drain=False)"})
            outcomes[f.id] = "dropped"
            continue
        X, doc = f.result(timeout=0)
        if doc.get("schema") == REJECT_SCHEMA:
            outcomes[f.id] = f"reject:{doc.get('reason')}"
            if doc.get("reason") != "shutdown":
                violations.append({"kind": "unstructured", "id": f.id,
                                   "detail": f"flushed with reason "
                                             f"{doc.get('reason')!r}"})
            else:
                n_flush += 1
        elif doc.get("status") == "ok":
            outcomes[f.id] = "ok"
            n_ok += 1
            if X is None or residual(A, B, X) > doc["tol"]:
                violations.append({"kind": "silent_garbage", "id": f.id,
                                   "detail": "ok result fails the "
                                             "trusted residual"})
        else:
            outcomes[f.id] = doc.get("status", "?")
            violations.append({"kind": "unstructured", "id": f.id,
                               "detail": "neither ok nor a shutdown "
                                         "reject under hard stop"})
    if not violations and n_ok + n_flush != requests:
        violations.append({"kind": "unstructured",
                           "detail": "outcome ledger does not cover "
                                     "the workload"})
    if n_flush == 0:
        violations.append({"kind": "vacuous",
                           "detail": "hard stop flushed nothing -- the "
                                     "under-load pin is unexercised"})
    late = front.submit("hpd", *workload[0])
    _, late_doc = late.result(timeout=5.0)
    if late_doc.get("schema") != REJECT_SCHEMA \
            or late_doc.get("reason") != "shutdown":
        violations.append({"kind": "unstructured",
                           "detail": "post-shutdown submit not rejected "
                                     "with reason='shutdown'"})
    return {"kind": "shutdown", "target": "pipeline",
            "mode": "drain_false", "op": "hpd", "column": "async",
            "requests": requests, "ok": n_ok, "flushed": n_flush,
            "fired": 0, "budget_s": None, "outcomes": outcomes,
            "verdict": "isolated" if not violations else "surfaced",
            "violations": violations}, front


#: the qr column's detection contract: the cells run
#: ``qr(..., abft=True)``, so ALL THREE kinds gate -- 'nan' and 'scale'
#: are caught by the health parity, and 'bitflip' (a shrinking
#: exponent-bit flip sits below the growth threshold) by the
#: Huang-Abraham column-sum checks, exactly as for lu / cholesky.  A silent undetected corruption
#: for ANY kind is a matrix violation.
QR_DETECTED_KINDS = ("bitflip", "scale", "nan")


def run_qr_cell(grid, *, kind: str, target: str, n: int = 16,
                nb: int = 8, call: int = 0, nelem: int = 2,
                seed: int = 13):
    """One qr-column cell: ``qr(..., abft=True, health=True)`` under a
    one-shot fault, classified against a clean reference run.

    The column runs the driver directly, not through serve admission.
    With ABFT guarding the EXPECTED verdict for every one-shot cell is ``absorbed``: the
    checksum checks detect the corrupted panel, the transaction layer
    re-executes it (``recompute_count == 1``), and the committed factor
    is bit-identical to the clean run -- graded against a clean
    ``64*n*eps``-class factorization residual besides the bitwise
    comparison.  ``surfaced`` (corrupted but flagged through abft /
    health) stays structured; ``undetected`` is a violation for every
    kind in :data:`QR_DETECTED_KINDS` (all three); a
    landed fault that is neither recovered nor surfaced -- or a recovery
    that costs more than the one corrupted panel -- is an
    ``unrecovered`` violation.  Returns ``(cell, plan)``."""
    import elemental_tpu_torch as et
    from ..core.distmatrix import to_global
    from ..resilience.abft import last_abft_report
    from ..resilience.health import HealthMonitor

    def host(x):
        return to_global(x).cpu().numpy()

    dtype = np.float32 if grid.device.type == "cuda" else np.float64
    eps = float(np.finfo(dtype).eps)
    rng = np.random.default_rng(seed)
    An = rng.normal(size=(n, n)).astype(dtype)
    clean = host(et.qr(et.from_global(An, et.MC, et.MR, grid=grid),
                       nb=nb)[0])
    plan = FaultPlan(seed=seed, faults=[
        FaultSpec(target, kind, call=call, nelem=nelem)])
    mon = HealthMonitor()
    with fault_injection(plan):
        out = et.qr(et.from_global(An, et.MC, et.MR, grid=grid), nb=nb,
                    abft=True, health=mon)
    rep = mon.report()
    arep = last_abft_report("qr")
    got = host(out[0])
    with np.errstate(over="ignore", invalid="ignore"):
        same = bool(np.allclose(got, clean, rtol=1e-6, atol=1e-9,
                                equal_nan=False))
    # trusted recomputed factorization residual ||A - Q R|| / ||A||
    Qg = host(et.explicit_q(out[0], out[1]))
    with np.errstate(over="ignore", invalid="ignore"):
        residual = float(np.linalg.norm(An - Qg @ np.triu(got))
                         / np.linalg.norm(An))
    res_ok = bool(np.isfinite(residual) and residual <= 64.0 * n * eps)
    detected = (rep["ok"] is False) or (arep["ok"] is False) \
        or bool(arep["violations"])
    verdict = "absorbed" if same and res_ok else \
        ("surfaced" if detected else "undetected")
    violations = []
    if plan.fired() == 0:
        violations.append({"kind": "vacuous",
                           "detail": "fault never landed"})
    if verdict == "undetected" and kind in QR_DETECTED_KINDS:
        violations.append({"kind": "silent_garbage",
                           "detail": f"qr {kind} corruption unflagged by "
                                     f"abft/health"})
    if plan.fired() and (verdict != "absorbed"
                         or arep["recompute_count"] != 1):
        violations.append(
            {"kind": "unrecovered",
             "detail": f"qr {kind}/{target} one-shot: verdict={verdict}, "
                       f"recompute_count={arep['recompute_count']} "
                       "(want absorbed at exactly one panel)"})
    return {"kind": kind, "target": target, "mode": "oneshot",
            "op": "qr", "requests": 1, "ok": int(same),
            "fired": plan.fired(), "budget_s": None,
            "outcomes": {"qr": verdict}, "verdict": verdict,
            "health_flags": [f["kind"] for f in rep["flags"]],
            "abft": {"ok": arep["ok"],
                     "violations": len(arep["violations"]),
                     "recompute_count": arep["recompute_count"],
                     "recovered_panels": arep["recovered_panels"]},
            "residual": residual,
            "violations": violations}, plan


def chaos_matrix(grid, *, kinds=FAULT_KINDS, targets=CHAOS_TARGETS,
                 modes=CHAOS_MODES, seed: int = 13, n: int = 16,
                 requests: int = 4, qr_column: bool = True,
                 async_column: bool = True, **kw):
    """The full acceptance matrix -> ``chaos_report/v1``.

    ``qr_column=True`` (default) appends the abft-guarded qr op column:
    one :func:`run_qr_cell` per (kind, target), all kinds gated
    (:data:`QR_DETECTED_KINDS`).

    ``async_column=True`` (default) appends the async column:
    one mid-pipeline :func:`run_async_cell` per (kind, mode) on the
    compute seam, plus one :func:`run_async_shutdown_cell`."""
    cells = []
    nviol = 0
    vacuous = 0
    for target in targets:
        for kind in kinds:
            for mode in modes:
                cell, plan, _ = run_cell(
                    grid, kind=kind, target=target, mode=mode, seed=seed,
                    n=n, requests=requests,
                    call=2 if target == "redistribute" else 0, **kw)
                if cell["fired"] == 0:
                    vacuous += 1
                    cell["violations"].append(
                        {"kind": "vacuous",
                         "detail": "fault never landed"})
                nviol += len(cell["violations"])
                cells.append(cell)
    if qr_column:
        for target in targets:
            for kind in kinds:
                cell, _ = run_qr_cell(grid, kind=kind, target=target,
                                      seed=seed)
                if cell["fired"] == 0:
                    vacuous += 1
                nviol += len(cell["violations"])
                cells.append(cell)
    if async_column:
        for kind in kinds:
            for mode in modes:
                cell, _, _ = run_async_cell(
                    grid, kind=kind, mode=mode, seed=seed, n=n,
                    requests=2 * requests, **kw)
                if cell["fired"] == 0:
                    vacuous += 1
                    cell["violations"].append(
                        {"kind": "vacuous",
                         "detail": "fault never landed"})
                nviol += len(cell["violations"])
                cells.append(cell)
        cell, _ = run_async_shutdown_cell(grid, n=n, seed=seed,
                                          requests=3 * requests)
        nviol += len(cell["violations"])
        cells.append(cell)
    return {"schema": CHAOS_SCHEMA, "grid": [grid.height, grid.width],
            "seed": seed, "cells": cells, "violations_total": nviol,
            "vacuous_cells": vacuous, "ok": nviol == 0}


# ---- fleet column ----------------------------------------------------

class _ChaosClock:
    """Manually advanced virtual clock for deterministic fleet cells."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t

    def sleep(self, dt: float) -> None:
        self.advance(dt)


class _TimedExecutor:
    """Saturation-cell executor shim: the member's REAL executor runs
    the batch, then the shared virtual clock jumps ``batch_s`` and the
    batch reports that duration -- so EWMA estimates, deadlines, and
    latency ledgers all see one consistent simulated timeline regardless
    of host speed.  Only ``run`` is shimmed: the sync service touches
    nothing else on the executor."""

    def __init__(self, inner, clock: _ChaosClock, batch_s: float):
        self._inner = inner
        self._clock = clock
        self.batch_s = float(batch_s)

    def run(self, bucket, reqs):
        xs, _ = self._inner.run(bucket, reqs)
        self._clock.advance(self.batch_s)
        return xs, self.batch_s

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _PoisonedExecutor:
    """Grid-loss-cell executor shim: every batch (and every bisect
    re-execution) on the poisoned member returns corrupted solutions, so
    certification fails persistently and the member's breaker trips --
    the 'grid died' stand-in.  Escalation bypasses the executor (the
    distributed certified path), so poisoned requests still end ok."""

    def __init__(self, inner):
        self._inner = inner

    def run(self, bucket, reqs):
        xs, seconds = self._inner.run(bucket, reqs)
        return [np.asarray(x) + 1.0e3 for x in xs], seconds

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _fleet_grade(futs, workload, violations, outcomes):
    """Shared fleet-cell grading: every future resolved, every outcome
    structured (ok with a passing trusted residual, a known reject
    reason, or a flagged failure/timeout).  Returns (n_ok, sheds)."""
    n_ok = 0
    sheds = []
    for i, (f, (A, B)) in enumerate(zip(futs, workload)):
        if not f.done():
            violations.append({"kind": "silent_drop", "id": i,
                               "detail": "future unresolved after drain"})
            outcomes[i] = "dropped"
            continue
        X, doc = f.result(timeout=0)
        if doc.get("schema") == REJECT_SCHEMA:
            reason = doc.get("reason")
            outcomes[i] = f"reject:{reason}:{doc.get('grid')}"
            if reason not in REJECT_REASONS:
                violations.append({"kind": "unstructured", "id": i,
                                   "detail": f"unknown reject {reason!r}"})
            sheds.append(doc)
        elif doc.get("status") == "ok":
            outcomes[i] = f"ok:{doc.get('grid')}:{doc.get('path')}"
            n_ok += 1
            if X is None or residual(A, B, X) > doc["tol"]:
                violations.append({"kind": "silent_garbage", "id": i,
                                   "detail": "ok result fails the trusted "
                                             "recomputed residual"})
        elif doc.get("status") in ("failed", "timed_out"):
            outcomes[i] = f"{doc['status']}:{doc.get('grid')}"
        else:
            outcomes[i] = str(doc.get("status"))
            violations.append({"kind": "unstructured", "id": i,
                               "detail": f"unexpected outcome {doc!r}"})
    return n_ok, sheds


def run_fleet_saturation_cell(*, grids: int = 2, n: int = 16,
                              nrhs: int = 2, max_batch: int = 4,
                              batch_s: float = 1.0,
                              budget_s: float | None = None,
                              light: int = 4, overload=(16, 32),
                              seed: int = 13):
    """Fleet saturation: overload sheds STRUCTURED, latency stays flat.

    A ``grids``-member sync fleet under a virtual clock: every executed
    batch advances injected time by ``batch_s`` and each member's EWMA
    is pre-seeded to it, so admission's wait estimates are exact.  One
    light wave (no shedding expected) then rising overload waves, each
    request carrying ``budget_s`` (default ``2.5 x batch_s``).  Pins:

      * every future resolves (zero silent drops);
      * at overload, sheds happen, every one a known structured reason
        CARRYING THE GRID ID that made the call;
      * the light wave sheds nothing (no vacuous over-shedding);
      * p99 virtual latency of ``ok`` requests stays within ``budget_s
        + 2 x batch_s`` at EVERY wave -- overload sheds instead of
        stretching admitted tails.

    Returns ``(cell_doc, fleet)``."""
    from .fleet import SolverFleet
    if budget_s is None:
        budget_s = 2.5 * batch_s
    clock = _ChaosClock()
    fleet = SolverFleet(grids=grids, pipelined=False, max_batch=max_batch,
                        shed=True, breaker_threshold=99, retries=0,
                        backoff_base_s=0.0, clock=clock,
                        sleep=clock.sleep)
    bucket = None
    for svc in fleet.services:
        svc.executor = _TimedExecutor(svc.executor, clock, batch_s)
    violations: list = []
    outcomes: dict = {}
    waves = []
    total_sheds = 0
    for wi, count in enumerate([light, *overload]):
        workload = build_workload("hpd", n, nrhs, count, seed + wi)
        futs = []
        for i, (A, B) in enumerate(workload):
            futs.append(fleet.submit("hpd", A, B, budget_s=budget_s,
                                     tenant=f"t{i % 2}"))
            if bucket is None and futs[-1].done() is False:
                # seed every member's EWMA at the simulated batch rate
                # (first wave, first admitted request fixes the bucket)
                from .admission import make_bucket
                bucket = make_bucket("hpd", n, nrhs, A.dtype)
                for svc in fleet.services:
                    svc.admission.observe_batch(bucket, batch_s)
        fleet.drain()
        wave_viol: list = []
        wave_out: dict = {}
        n_ok, sheds = _fleet_grade(futs, workload, wave_viol, wave_out)
        for doc in sheds:
            if doc.get("grid") is None:
                wave_viol.append({
                    "kind": "unstructured",
                    "detail": f"shed {doc.get('reason')!r} without a "
                              f"grid attribution"})
        lat = sorted(f.result(0)[1]["latency_s"] for f in futs
                     if f.done() and f.result(0)[1].get("status") == "ok")
        p99 = lat[max(int(0.99 * len(lat)) - 1, 0)] if lat else 0.0
        bound = budget_s + 2.0 * batch_s
        if p99 > bound:
            wave_viol.append({
                "kind": "unstructured",
                "detail": f"wave {count}: admitted p99 {p99:.3g}s exceeds "
                          f"{bound:.3g}s -- overload stretched the tail "
                          f"instead of shedding"})
        if wi == 0 and sheds:
            wave_viol.append({"kind": "vacuous",
                              "detail": "light wave shed load"})
        waves.append({"requests": count, "ok": n_ok,
                      "sheds": len(sheds), "p99_s": p99})
        total_sheds += len(sheds) if wi > 0 else 0
        violations.extend(wave_viol)
        outcomes.update({f"w{wi}:{k}": v for k, v in wave_out.items()})
    if total_sheds == 0:
        violations.append({"kind": "vacuous",
                           "detail": "overload waves never shed -- the "
                                     "saturation pin is unexercised"})
    fleet.shutdown(drain=True)
    return {"kind": "saturation", "target": "fleet", "mode": "overload",
            "op": "hpd", "column": "fleet", "grids": grids,
            "requests": light + sum(overload), "waves": waves,
            "ok": sum(w["ok"] for w in waves), "fired": total_sheds,
            "budget_s": budget_s, "outcomes": outcomes,
            "verdict": "isolated" if not violations else "surfaced",
            "violations": violations}, fleet


def run_fleet_grid_loss_cell(*, n: int = 16, nrhs: int = 2,
                             requests: int = 8, seed: int = 13):
    """Grid loss: one member's breaker opens, traffic re-routes.

    A 2-member sync fleet (``max_batch=2``, ``breaker_threshold=2``)
    whose member ``g0`` gets a poisoned executor: every fast-path batch
    it runs certifies FALSE, so two consecutive batches trip its breaker
    while the poisoned requests recover through the distributed
    escalation path.  The clock is virtual and never advanced, so the
    cooldown never elapses -- ``g0`` stays lost.  Phase A routes
    ``requests`` across both members (backlog-tie alternation) and trips
    ``g0``; phase B submits ``requests`` more and pins that EVERY one is
    served by ``g1`` on the fast path.  Zero silent drops, zero sheds,
    zero silent garbage; deterministic outcome/grid/path ledger (the
    replay oracle runs the cell twice and compares).  Returns
    ``(cell_doc, fleet)``."""
    from .fleet import SolverFleet
    from .policy import OPEN
    clock = _ChaosClock()
    fleet = SolverFleet(grids=2, pipelined=False, max_batch=2,
                        shed=False, breaker_threshold=2, retries=0,
                        backoff_base_s=0.0, breaker_cooldown_s=1.0e9,
                        clock=clock, sleep=clock.sleep)
    fleet.services[0].executor = _PoisonedExecutor(
        fleet.services[0].executor)
    violations: list = []
    outcomes: dict = {}
    workload_a = build_workload("hpd", n, nrhs, requests, seed)
    futs_a = [fleet.submit("hpd", A, B, tenant="a") for A, B in workload_a]
    fleet.drain()
    out_a: dict = {}
    ok_a, sheds_a = _fleet_grade(futs_a, workload_a, violations, out_a)
    outcomes.update({f"a:{k}": v for k, v in out_a.items()})
    if ok_a != requests:
        violations.append({
            "kind": "collateral",
            "detail": f"phase A: {requests - ok_a} poisoned-member "
                      f"requests did not recover via escalation"})
    g0_served = sum(1 for f in futs_a
                    if f.done() and f.result(0)[1].get("grid") == "g0")
    if g0_served == 0:
        violations.append({"kind": "vacuous",
                           "detail": "phase A never touched the poisoned "
                                     "member"})
    br0 = fleet.services[0].breakers
    if not any(b.state == OPEN for b in br0.values()):
        violations.append({"kind": "vacuous",
                           "detail": "poisoned member's breaker never "
                                     "opened -- no grid loss happened"})
    elif fleet.flight.last_dump() is None:
        violations.append({"kind": "unstructured",
                           "detail": "breaker opened but the flight "
                                     "recorder never dumped"})
    workload_b = build_workload("hpd", n, nrhs, requests, seed + 1)
    futs_b = [fleet.submit("hpd", A, B, tenant="b") for A, B in workload_b]
    fleet.drain()
    out_b: dict = {}
    ok_b, sheds_b = _fleet_grade(futs_b, workload_b, violations, out_b)
    outcomes.update({f"b:{k}": v for k, v in out_b.items()})
    for i, f in enumerate(futs_b):
        if not f.done():
            continue
        _, doc = f.result(timeout=0)
        if doc.get("grid") != "g1" or doc.get("path") != "fastpath" \
                or doc.get("status") != "ok":
            violations.append({
                "kind": "collateral", "id": i,
                "detail": f"phase B request not re-routed to the healthy "
                          f"member fast path: grid={doc.get('grid')!r} "
                          f"path={doc.get('path')!r} "
                          f"status={doc.get('status')!r}"})
    if sheds_a or sheds_b:
        violations.append({"kind": "collateral",
                           "detail": "grid loss shed load instead of "
                                     "re-routing it"})
    fleet.shutdown(drain=True)
    return {"kind": "grid_loss", "target": "fleet", "mode": "persistent",
            "op": "hpd", "column": "fleet", "grids": 2,
            "requests": 2 * requests, "ok": ok_a + ok_b, "fired": g0_served,
            "budget_s": None, "outcomes": outcomes,
            # the breaker-open dump: the flight recorder's
            # retrospective of everything the fleet did before the trip;
            # deterministic under the virtual clock, so replays compare
            # it bit-for-bit
            "flight": fleet.flight.last_dump(),
            "verdict": "isolated" if not violations else "surfaced",
            "violations": violations}, fleet


def fleet_replay_identical(*, n: int = 16, requests: int = 8,
                           seed: int = 29) -> bool:
    """Run the grid-loss cell twice with the same seed: identical
    outcome/grid/path ledgers and verdicts (the fleet's determinism
    oracle -- sync mode is single-threaded under a virtual clock, so
    routing, breaker trips, and escalations replay bit-identically)."""
    c1, _ = run_fleet_grid_loss_cell(n=n, requests=requests, seed=seed)
    c2, _ = run_fleet_grid_loss_cell(n=n, requests=requests, seed=seed)
    same = [c1["outcomes"][k] for k in sorted(c1["outcomes"])] \
        == [c2["outcomes"][k] for k in sorted(c2["outcomes"])]
    # the breaker-open flight dump must replay BIT-IDENTICALLY: the
    # recorder touches only the injected clock and lock-ordered
    # sequence numbers, so the serialized dumps compare byte-for-byte
    same_flight = json.dumps(c1.get("flight"), sort_keys=True) \
        == json.dumps(c2.get("flight"), sort_keys=True)
    return same and same_flight and c1["verdict"] == c2["verdict"] \
        and c1["ok"] == c2["ok"]


def replay_identical(grid, *, kind: str = "bitflip",
                     target: str = "compute", mode: str = "persistent",
                     seed: int = 29, **kw) -> bool:
    """Replay one cell twice with the same seed: bit-identical fault
    logs AND identical per-request outcomes (the determinism oracle the
    breaker/chaos tests build on)."""
    c1, p1, _ = run_cell(grid, kind=kind, target=target, mode=mode,
                         seed=seed, **kw)
    c2, p2, _ = run_cell(grid, kind=kind, target=target, mode=mode,
                         seed=seed, **kw)
    same_outcomes = [c1["outcomes"][k] for k in sorted(c1["outcomes"])] \
        == [c2["outcomes"][k] for k in sorted(c2["outcomes"])]
    return logs_identical(p1, p2) and same_outcomes \
        and c1["verdict"] == c2["verdict"]
