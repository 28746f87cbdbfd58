"""The solver service: deadline-bounded, batched, fault-isolated solves.

PyTorch port of ``elemental_tpu/serve/service.py``: the front-end
gluing the serve layers together::

    submit ->  admission (bucket, deadline, load shed, breaker gate)
    drain  ->  executor  (padded batch, captured once, one dispatch)
           ->  certify   (trusted host residual per request)
           ->  isolate   (bisect-split a failing batch: one poisoned
                          problem fails ALONE, batch-mates still certify;
                          re-execution absorbs one-shot faults)
           ->  escalate  (retry/backoff around ``certified_solve`` with
                          the deadline threaded and the load-aware
                          degradation ladder)

Every request ends in exactly one structured outcome -- ``serve_result/
v1`` with status ``ok`` / ``failed`` / ``timed_out``, or a
``serve_reject/v1`` at submit -- and every ``ok`` carries a residual
measured on the TRUSTED host path: zero silent garbage by construction
(the chaos matrix pins it under fault injection).

The service is synchronous and deterministic: ``submit`` enqueues (or
fast-rejects), ``drain`` processes the queue to completion.  An async
front-end is one thread + this object; determinism (injectable clock +
sleep, seeded jitter) is what makes the breaker/chaos tests replayable.

Observability: per-request latency histograms, queue-depth / pressure /
breaker gauges, and -- when an ``obs.Tracer`` is active -- one span per
batch and per escalated request, riding the same ``phase_hook`` seam as
the drivers.

Where a request leaves the batch path -- ``fastpath=False``, an open
breaker, a batch member that fails certification down to a singleton,
a measured ``'grid'`` route -- it runs the distributed drivers on the
service's grid, and with them the hand-written kernels: ``lu`` /
``hpd`` through ``certified_solve`` (``lu_panel`` / ``potrf_inv``),
``lstsq`` through ``least_squares(abft=True)`` (``qr_panel``).  The
service runs on its grid's device: ``cuda:0`` unless the caller passes
a CPU grid (or makes one the default grid).
"""
from __future__ import annotations

import time

import numpy as np

from ..obs import metrics as _metrics
from ..obs.lifecycle import RequestTrace
from ..obs.tracer import active_tracer, phase_hook
from ..resilience.certify import certified_solve, default_tol
from .admission import AdmissionController, Bucket, Deadline, reject_doc
from .executor import (DEVICE_GATE, Executor, _backend, ls_residual,
                       residual, route_for)
from .policy import (DEGRADE_PRESSURE, OPEN, CircuitBreaker, RetryPolicy,
                     select_ladder)

RESULT_SCHEMA = "serve_result/v1"


class SolverService:
    """See module docstring.  ``grid`` is the escalation grid (default:
    the process default grid), and its device is where the batches run;
    ``fastpath=False`` routes every request
    straight to the certified distributed path (the big-problem /
    chaos-redist serving mode).  ``clock``/``sleep`` are injectable for
    deterministic tests."""

    def __init__(self, grid=None, *, max_batch: int = 8, capacity: int = 16,
                 shed: bool = True, fastpath: bool = True,
                 health: bool = True, seed: int = 0,
                 breaker_threshold: int = 3, breaker_cooldown_s: float = 1.0,
                 retries: int = 1, backoff_base_s: float = 0.05,
                 degrade_pressure: float = DEGRADE_PRESSURE,
                 escalate_nb: int | None = None, tol_factor: float = 1.0,
                 flops_per_s: float | None = None,
                 hbm_bytes: float | None = None,
                 pipeline_depth: int = 2,
                 name: str | None = None, tune_ns: str = "",
                 device=None,
                 clock=time.monotonic, sleep=None, flight=None):
        self.grid = grid
        self.max_batch = max(int(max_batch), 1)
        self.capacity = max(int(capacity), 1)
        self.fastpath = bool(fastpath)
        self.health = bool(health)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.degrade_pressure = float(degrade_pressure)
        self.escalate_nb = escalate_nb
        self.tol_factor = float(tol_factor)
        #: fleet identity: ``name`` labels this member's metric series
        #: and stamps its result/reject docs; ``tune_ns`` namespaces its
        #: tuner constants; ``device`` (its lead rank slot) names its
        #: batch entries.  All default off -- a direct SolverService has
        #: unlabeled gauges and ``grid: None`` in its docs.
        self.name = name
        self.tune_ns = str(tune_ns)
        #: flight recorder: shared ring the breakers,
        #: lifecycle traces and reject paths all feed; a fleet passes
        #: ONE recorder to every member, None = not recording
        self.flight = flight
        self.clock = clock
        self._sleep = sleep if sleep is not None else time.sleep
        kw = {} if flops_per_s is None else {"flops_per_s": flops_per_s}
        if hbm_bytes is not None:
            kw["hbm_bytes"] = hbm_bytes
        self.admission = AdmissionController(
            shed=shed, max_batch=self.max_batch, clock=clock,
            pipeline_depth=pipeline_depth, grid=name, **kw)
        self.executor = Executor(clock=clock, device=device,
                                 tune_ns=self.tune_ns)
        if grid is not None:
            self.executor.place = grid.device
            self.admission.backend = _backend(grid.device)
        self.retry = RetryPolicy(retries=retries, base_s=backoff_base_s,
                                 seed=seed)
        self.breakers: dict = {}         # bucket.key() -> CircuitBreaker
        self._queues: dict = {}          # Bucket -> [SolveRequest]
        self.results: dict = {}          # id -> serve_result/v1 | reject
        self.solutions: dict = {}        # id -> np.ndarray
        self._shutdown = False           # set by shutdown(); rejects submits
        self._dispatch: dict = {}        # id -> tuner-fed routing provenance
        #: streaming completion hook: called as
        #: ``on_result(id, doc, x)`` the moment a request finalizes --
        #: BEFORE drain returns -- so an async front can resolve futures
        #: per batch.  A raising hook never poisons batch-mates.
        self.on_result = None

    # ---- bookkeeping -------------------------------------------------
    def _grid(self):
        if self.grid is None:
            from ..core.grid import default_grid
            self.grid = default_grid()
        return self.grid

    def breaker(self, bucket: Bucket) -> CircuitBreaker:
        br = self.breakers.get(bucket.key())
        if br is None:
            br = self.breakers[bucket.key()] = CircuitBreaker(
                bucket.key(), threshold=self.breaker_threshold,
                cooldown_s=self.breaker_cooldown_s, clock=self.clock,
                grid=self.name, flight=self.flight)
        return br

    def queue_depth(self, bucket: Bucket | None = None) -> int:
        if bucket is not None:
            return len(self._queues.get(bucket, ()))
        return sum(len(q) for q in self._queues.values())

    def pressure(self) -> float:
        """Queue depth / capacity: the degradation + shedding signal."""
        return self.queue_depth() / self.capacity

    def _gauges(self) -> None:
        if self.name is None:
            _metrics.set_gauge("serve_queue_depth", self.queue_depth())
            _metrics.set_gauge("serve_pressure", self.pressure())
        else:
            # fleet members label their series per grid so
            # the pool's gauges do not clobber each other
            _metrics.set_gauge("serve_queue_depth", self.queue_depth(),
                               grid=self.name)
            _metrics.set_gauge("serve_pressure", self.pressure(),
                               grid=self.name)

    def _tol(self, req) -> float:
        return self.tol_factor * default_tol(req.n, req.A.dtype)

    def _route(self, bucket: Bucket):
        """Tuner-fed dispatch decision for this batch's bucket:
        per-request batch estimate from the admission EWMA vs the tuning
        cache's measured grid winner."""
        est = self.admission.estimate_batch_s(bucket) / self.max_batch
        g = self._grid()
        return route_for(bucket, (g.height, g.width),
                         _backend(self.executor.place), est,
                         ns=self.tune_ns)

    # ---- submit ------------------------------------------------------
    def submit(self, op: str, A, B, *, budget_s: float | None = None,
               deadline: Deadline | None = None,
               tenant: str | None = None, trace=None):
        """Admit one request.  Returns the request id (int) on accept or
        a structured ``serve_reject/v1`` dict on fast reject (load shed,
        expired deadline, open breaker, malformed request).  ``tenant``
        rides into the result/reject documents (the fleet path; quota
        enforcement itself lives in the fleet scheduler).
        ``trace`` is the request's lifecycle trace -- the
        fleet passes the one it opened at fleet submit; a direct caller
        gets a fresh one so every outcome doc carries a ``timeline``."""
        if deadline is None and budget_s is not None:
            deadline = Deadline(budget_s, clock=self.clock)
        if trace is None:
            trace = RequestTrace(clock=self.clock, tenant=tenant, op=op,
                                 flight=self.flight)
            trace.mark("submitted", op=op)
        if self._shutdown:
            rej = reject_doc("shutdown", queue_depth=self.queue_depth(),
                             deadline=deadline, grid=self.name,
                             tenant=tenant, trace=trace,
                             detail="service has shut down")
            self._flight_reject("shutdown", tenant)
            _metrics.inc("serve_rejects", reason="shutdown")
            return rej
        req = self.admission.admit(op, A, B, deadline=deadline,
                                   queue_depth=self.queue_depth,
                                   tenant=tenant, trace=trace)
        if isinstance(req, dict):        # bad_request / expired / shed
            self._flight_reject(req["reason"], tenant)
            _metrics.inc("serve_rejects", reason=req["reason"])
            return req
        bucket = req.bucket
        br = self.breaker(bucket)
        if br.state == OPEN:
            # peek-only: the half-open probe slot belongs to QUEUED work,
            # so an open breaker sheds new submissions without consuming it
            elapsed_ok = br.opened_at is not None \
                and self.clock() - br.opened_at >= br.cooldown_s
            if not elapsed_ok:
                rej = reject_doc("breaker_open", bucket=bucket,
                                 queue_depth=self.queue_depth(bucket),
                                 deadline=deadline, grid=self.name,
                                 tenant=tenant, trace=trace,
                                 detail=f"breaker open for {bucket.key()}")
                self._flight_reject("breaker_open", tenant)
                _metrics.inc("serve_rejects", reason="breaker_open")
                return rej
        self._queues.setdefault(bucket, []).append(req)
        self._gauges()
        return req.id

    def _flight_reject(self, reason: str, tenant) -> None:
        if self.flight is not None:
            self.flight.record("reject", reason=reason, grid=self.name,
                               tenant=tenant)

    def _pop_batch(self):
        """FIFO batch pop: the bucket whose HEAD request is oldest
        yields up to ``max_batch`` requests; None when nothing queued."""
        if not self._queues:
            return None
        bucket = min(self._queues,
                     key=lambda b: self._queues[b][0].submitted)
        q = self._queues[bucket]
        batch, rest = q[:self.max_batch], q[self.max_batch:]
        if rest:
            self._queues[bucket] = rest
        else:
            del self._queues[bucket]
        self._gauges()
        return bucket, batch

    # ---- drain -------------------------------------------------------
    def drain(self) -> dict:
        """Process the queue to completion; returns {id: result doc} for
        everything finalized by this call."""
        tm = phase_hook("serve")
        tm.start()
        done: dict = {}
        before = set(self.results)
        bi = 0
        while True:
            popped = self._pop_batch()
            if popped is None:
                break
            bucket, batch = popped
            self._run_batch(bucket, batch, tm, bi)
            bi += 1
        for rid, doc in self.results.items():
            if rid not in before:
                done[rid] = doc
        self._gauges()
        return done

    def shutdown(self, drain: bool = True) -> dict:
        """Graceful stop: nothing queued is dropped silently.

        With ``drain=True`` (default) the queue is processed to
        completion first -- every queued request finishes through the
        normal path.  With ``drain=False`` (emergency stop) queued
        requests are flushed UNEXECUTED: each gets a structured
        ``serve_reject/v1`` with ``reason='shutdown'`` (plus its request
        ``id``) recorded in :attr:`results`.  Either way the service
        then rejects new ``submit`` calls with ``reason='shutdown'``
        and ``shutdown`` is idempotent.  Returns ``{id: doc}`` for every
        request settled by this call."""
        done: dict = {}
        if drain:
            done.update(self.drain())
        for bucket in sorted(self._queues, key=lambda b: b.key()):
            for req in self._queues[bucket]:
                rej = reject_doc("shutdown", bucket=bucket,
                                 queue_depth=0, deadline=req.deadline,
                                 grid=self.name, tenant=req.tenant,
                                 trace=req.trace,
                                 detail="flushed by shutdown(drain=False)")
                rej["id"] = req.id
                self.results[req.id] = rej
                done[req.id] = rej
                self._flight_reject("shutdown", req.tenant)
                _metrics.inc("serve_rejects", reason="shutdown")
                if self.on_result is not None:
                    # flushed requests are completions too: a front
                    # holding futures for them must see them resolve
                    try:
                        self.on_result(req.id, rej, None)
                    except Exception:
                        _metrics.inc("serve_callback_errors", op=req.op)
        self._queues.clear()
        self._shutdown = True
        self._gauges()
        return done

    def solve(self, op: str, A, B, *, budget_s: float | None = None):
        """Convenience synchronous one-shot: submit + drain.  Returns
        ``(X, doc)`` where doc is a result or reject document."""
        rid = self.submit(op, A, B, budget_s=budget_s)
        if isinstance(rid, dict):
            return None, rid
        self.drain()
        return self.solutions.get(rid), self.results[rid]

    # ---- the batch pipeline ------------------------------------------
    def _run_batch(self, bucket: Bucket, reqs, tm, bi: int) -> None:
        live = self._prepare_batch(bucket, reqs)
        if not live:
            return
        tr = active_tracer()
        span = tr.span(f"serve:batch:{bucket.key()}", n=len(live)) \
            if tr is not None else _null_cm()
        with span:
            xs, seconds = self.executor.run(bucket, live)
        tm.tick("batch", bi)
        self._complete_batch(bucket, live, xs, seconds)

    def _prepare_batch(self, bucket: Bucket, reqs) -> list:
        """Pre-execution leg of the batch pipeline: drop expired
        requests, honor the breaker gate, and make the tuner-fed
        dispatch decision.  Returns the live requests to batch-execute
        on the vmap path, or ``[]`` when everything already settled
        (dropped / escalated / grid-routed).  The async front calls this
        and :meth:`_complete_batch` directly so batch k+1's host staging
        can overlap batch k's device execution."""
        live = []
        for req in reqs:
            if req.deadline is not None and req.deadline.expired():
                self._finalize(req, bucket, status="timed_out",
                               path="dropped", timed_out=True)
            else:
                live.append(req)
        if not live:
            return []
        br = self.breaker(bucket)
        if not (self.fastpath and br.allow()):
            _metrics.inc("serve_fastpath_bypass", op=bucket.op)
            for req in live:
                self._escalate(bucket, req)
            return []
        route, prov = self._route(bucket)
        for req in live:
            self._dispatch[req.id] = prov
        if route == "grid":
            # the tuner's measured grid winner beats the per-request
            # batch estimate: serve each request on the distributed path
            _metrics.inc("serve_grid_dispatch", op=bucket.op)
            for req in live:
                self._escalate(bucket, req, path="grid")
            return []
        return live

    def _complete_batch(self, bucket: Bucket, live, xs,
                        seconds: float) -> None:
        """Post-execution leg: EWMA feedback, trusted certification,
        breaker bookkeeping, bisect isolation of failures."""
        self.admission.observe_batch(bucket, seconds)
        br = self.breaker(bucket)
        passed, failed = self._certify(bucket, live, xs)
        if failed:
            br.record_failure()
        else:
            br.record_success()
        if failed:
            self._isolate(bucket, failed)

    def _certify(self, bucket: Bucket, reqs, xs, path="fastpath"):
        """Trusted per-request residuals; finalize passes, return fails."""
        meas = ls_residual if bucket.op == "lstsq" else residual
        passed, failed = [], []
        for req, X in zip(reqs, xs):
            res = meas(req.A, req.B, X)
            ok = res <= self._tol(req)
            if req.trace is not None:
                req.trace.mark("certified", ok=bool(ok),
                               residual=float(res))
            if ok:
                self._finalize(req, bucket, status="ok", path=path,
                               rung="fastpath", residual=res, x=X)
                passed.append(req)
            else:
                failed.append(req)
        return passed, failed

    def _isolate(self, bucket: Bucket, reqs, depth: int = 0) -> None:
        """Bisect-split a failing group: fresh re-executions certify the
        clean batch-mates (and absorb one-shot faults); a singleton gets
        ONE fresh solo re-execution (the cheap transient-fault retry)
        and only then escapes to the escalation ladder ALONE."""
        if len(reqs) == 1:
            if depth == 0:
                # the batch itself was the singleton: no re-execution
                # evidence yet, give it the solo retry too
                xs, _ = self.executor.run(bucket, reqs)
                _, failed = self._certify(bucket, reqs, xs)
                if not failed:
                    return
            self._escalate(bucket, reqs[0], bisected=True)
            return
        _metrics.inc("serve_bisect_splits", op=bucket.op)
        mid = (len(reqs) + 1) // 2
        for half in (reqs[:mid], reqs[mid:]):
            if not half:
                continue
            xs, _ = self.executor.run(bucket, half)
            _, failed = self._certify(bucket, half, xs)
            if failed:
                if len(half) == 1:
                    self._escalate(bucket, half[0], bisected=True)
                else:
                    self._isolate(bucket, failed, depth + 1)

    # ---- escalation --------------------------------------------------
    def _escalate(self, bucket: Bucket, req, bisected: bool = False,
                  path: str = "escalated") -> None:
        if req.trace is not None:
            req.trace.mark("escalated", path=path, bisected=bool(bisected))
        tr = active_tracer()
        span = tr.span(f"serve:req:{req.id}", op=req.op, grid=self.name,
                       tenant=req.tenant) \
            if tr is not None else _null_cm()
        with span, DEVICE_GATE.exclusive():
            # the distributed drivers' device work, their own graph
            # captures included: alone among the serve layer's device calls
            self._escalate_inner(bucket, req, bisected, path)

    def _escalate_inner(self, bucket, req, bisected: bool,
                        path: str = "escalated") -> None:
        from ..core.dist import MC, MR
        from ..core.distmatrix import from_global
        if req.deadline is not None and req.deadline.expired():
            self._finalize(req, bucket, status="timed_out", path=path,
                           timed_out=True, bisected=bisected)
            return
        if req.op == "lstsq":
            self._escalate_lstsq(bucket, req, bisected, path)
            return
        ladder = select_ladder(req.op, self.pressure(),
                               self.degrade_pressure)
        tol = self._tol(req)
        g = self._grid()
        retries = 0
        cert = None
        X = None
        for attempt in range(self.retry.retries + 1):
            Ad = from_global(req.A, MC, MR, grid=g)
            Bd = from_global(req.B, MC, MR, grid=g)
            Xd, cert = certified_solve(req.op, Ad, Bd, tol=tol,
                                       nb=self.escalate_nb, ladder=ladder,
                                       health=self.health,
                                       deadline=req.deadline)
            # owned copy: ``.numpy()`` of a CPU tensor is a zero-copy
            # view of its storage, which the allocator reuses once the
            # tensor drops -- a stored solution would silently mutate
            # under a later solve
            X = None if Xd is None else np.array(
                _to_host(Xd), dtype=np.float64)
            if req.trace is not None:
                req.trace.mark("certified", ok=bool(cert["certified"]),
                               residual=cert["residual"],
                               rung=str(cert["rung"]))
            _metrics.inc("serve_escalations", op=req.op,
                         rung=str(cert["rung"]))
            if cert["certified"]:
                self._finalize(req, bucket, status="ok", path=path,
                               rung=cert["rung"], residual=cert["residual"],
                               x=X, certificate=cert, retries=retries,
                               bisected=bisected)
                return
            if cert["timed_out"]:
                break
            if attempt < self.retry.retries:
                delay = self.retry.delay_s(req.id, attempt + 1,
                                           req.deadline)
                if delay < 0.0:
                    break                # no budget left for a retry
                if delay > 0.0:
                    self._sleep(delay)
                retries += 1
                _metrics.inc("serve_retries", op=req.op)
        timed_out = bool(cert is not None and cert["timed_out"])
        self._finalize(req, bucket,
                       status="timed_out" if timed_out else "failed",
                       path=path, rung=None,
                       residual=None if cert is None else cert["residual"],
                       x=X, certificate=cert, retries=retries,
                       timed_out=timed_out, bisected=bisected)

    def _escalate_lstsq(self, bucket, req, bisected: bool,
                        path: str = "escalated") -> None:
        """Least-squares escalation: the DISTRIBUTED QR path
        (``lapack.qr.least_squares``) with the same retry/backoff and
        trusted normal-equations certification as the square ladder
        (``certified_solve`` has no lstsq rung -- the grid solve IS the
        stronger rung here).  The factorization runs ABFT-guarded: a
        transient fault inside the escalation QR is detected at the
        corrupted panel and repaired by one panel re-execution instead of
        burning a whole serve retry -- every escalation rung is
        corruption-attested."""
        from ..core.dist import MC, MR
        from ..core.distmatrix import from_global
        from ..lapack import least_squares
        tol = self._tol(req)
        g = self._grid()
        retries = 0
        res = None
        X = None
        for attempt in range(self.retry.retries + 1):
            if req.deadline is not None and req.deadline.expired():
                self._finalize(req, bucket, status="timed_out", path=path,
                               timed_out=True, bisected=bisected,
                               retries=retries)
                return
            Ad = from_global(req.A, MC, MR, grid=g)
            Bd = from_global(req.B, MC, MR, grid=g)
            Xd = least_squares(Ad, Bd, nb=self.escalate_nb, abft=True)
            X = np.array(_to_host(Xd), dtype=np.float64)   # owned copy
            res = ls_residual(req.A, req.B, X)
            if req.trace is not None:
                req.trace.mark("certified", ok=bool(res <= tol),
                               residual=float(res), rung="grid_qr")
            _metrics.inc("serve_escalations", op=req.op, rung="grid_qr")
            if res <= tol:
                self._finalize(req, bucket, status="ok", path=path,
                               rung="grid_qr", residual=res, x=X,
                               retries=retries, bisected=bisected)
                return
            if attempt < self.retry.retries:
                delay = self.retry.delay_s(req.id, attempt + 1, req.deadline)
                if delay < 0.0:
                    break
                if delay > 0.0:
                    self._sleep(delay)
                retries += 1
                _metrics.inc("serve_retries", op=req.op)
        self._finalize(req, bucket, status="failed", path=path, rung=None,
                       residual=res, x=X, retries=retries,
                       bisected=bisected)

    # ---- finalize ----------------------------------------------------
    def _finalize(self, req, bucket: Bucket, *, status: str, path: str,
                  rung: str | None = None, residual: float | None = None,
                  x=None, certificate: dict | None = None, retries: int = 0,
                  timed_out: bool = False, bisected: bool = False) -> None:
        latency = self.clock() - req.submitted
        if req.trace is not None:
            req.trace.annotate(grid=self.name, bucket=bucket, op=req.op)
            req.trace.mark("done", status=status, path=path)
        doc = {"schema": RESULT_SCHEMA, "id": req.id, "op": req.op,
               "n": req.n, "nrhs": req.nrhs, "bucket": bucket.key(),
               "status": status, "path": path, "rung": rung,
               "residual": residual, "tol": self._tol(req),
               "retries": int(retries), "bisected": bool(bisected),
               "timed_out": bool(timed_out), "latency_s": float(latency),
               "deadline": req.deadline.to_doc()
               if req.deadline is not None else None,
               "certificate": certificate,
               "breaker": self.breaker(bucket).state,
               "dispatch": self._dispatch.pop(req.id, None),
               "grid": self.name, "tenant": req.tenant,
               "timeline": req.trace.to_doc()
               if req.trace is not None else None}
        self.results[req.id] = doc
        if self.flight is not None and status == "failed":
            # an unrecovered request -- escalation + bisection exhausted
            # -- is a flight-recorder dump trigger
            self.flight.trigger("unrecovered", id=req.id, op=req.op,
                                bucket=bucket.key(), grid=self.name,
                                tenant=req.tenant)
        x_out = x if status == "ok" else None
        if x_out is not None:
            self.solutions[req.id] = x_out
        _metrics.inc("serve_requests", op=req.op, status=status)
        if self.name is None:
            _metrics.observe("serve_latency_seconds", float(latency),
                             op=req.op)
        else:
            _metrics.observe("serve_latency_seconds", float(latency),
                             op=req.op, grid=self.name)
        if req.tenant is not None:
            _metrics.observe("serve_tenant_latency_seconds", float(latency),
                             tenant=req.tenant)
        if self.on_result is not None:
            try:
                self.on_result(req.id, doc, x_out)
            except Exception:
                # a raising completion callback must never poison the
                # batch-mates still being finalized
                _metrics.inc("serve_callback_errors", op=req.op)


def _to_host(Xd) -> np.ndarray:
    from ..core.distmatrix import to_global
    return to_global(Xd).cpu().numpy()


class _null_cm:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
