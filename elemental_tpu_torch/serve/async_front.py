"""Async pipelined front-end: overlapped admission/execution around the
synchronous :class:`~.service.SolverService` core.

PyTorch port of ``elemental_tpu/serve/async_front.py``.  The core stays
deliberately synchronous and deterministic; this module adds exactly one
worker thread and a thread-safe submission queue, and gets its
throughput from TWO overlaps the synchronous path cannot have:

  * **depth-k pipelining** -- a dispatch only queues device work on the
    executor's stream, so the worker STAGES (host pad/stack into pinned
    buffers + entry lookup + the copies to the device) and DISPATCHES
    (graph replay + read-back + event) up to ``depth`` batches before
    collecting the oldest.  The default ``depth=2`` is the classic
    double buffer; a fleet member facing a deep submit queue runs
    ``depth=3+`` so the device queue never drains even when one
    host-side collect runs long::

        host   : stage k | stage k+1 | collect k | stage k+2 | collect k+1
        device :         |-- solve k --|-- solve k+1 --|-- solve k+2 --|

  * **buffer donation** -- with ``donate=True`` (default) a batch is
    copied from its pinned staging buffers straight into the captured
    entry's static inputs, which then belong to the batch until its
    replay, so steady-state serving allocates no device operands.
    Donated operands are gone after dispatch; the executor drops its
    references.  :func:`donation_safe` says where the front donates.

Completions STREAM: every ``submit`` returns a :class:`ServeFuture`
that resolves (with its unchanged ``serve_result/v1`` doc) the moment
its batch certifies -- not at drain -- via the core's ``on_result``
hook; per-future callbacks fire on the worker thread.

All core state (queues, breakers, results) is touched ONLY by the
worker thread -- ``submit`` just enqueues -- so the core needs no
locks and stays bit-identical to the synchronous path for the same
request set (the bench asserts exactly that).  The price of pipelining
is that admission/breaker decisions for batch k+1 may be made before
batch k's outcome lands; the chaos matrix's async column pins that a
mid-pipeline fault is still isolated to its own batch.

Observability: ``serve_async_submit_queue`` / ``serve_async_inflight``
gauges, per-stage latency histograms (from the executor), and a
``serve_pipeline_occupancy`` gauge (device-busy seconds / worker
wall-clock -- 1.0 means the device never waited on the host).  See
ADVICE.md for how to read them.

Shutdown semantics (both idempotent, both join the worker -- no thread
leaks):

  * ``shutdown(drain=True)`` -- stop accepting, finish EVERYTHING
    queued through the normal pipeline, resolve every future.
  * ``shutdown(drain=False)`` -- emergency stop: the in-flight batch
    (already on device) completes, everything still queued -- ingested
    or not -- resolves with a structured ``serve_reject/v1``
    (``reason='shutdown'``).  Zero silent drops: every future issued
    ever resolves.
"""
from __future__ import annotations

import queue
import threading

from ..obs import metrics as _metrics
from ..obs.lifecycle import RequestTrace
from .admission import Deadline, reject_doc
from .service import SolverService

#: worker idle poll (seconds): how quickly the worker notices new
#: submissions / stop flags when nothing is queued.  Wake-ups are
#: event-driven (a sentinel rides the queue), so this is a backstop.
POLL_S = 0.05


def donation_safe() -> bool:
    """May the PIPELINED front donate batch buffers on the default
    grid's device?

    On the card, yes: a donated batch is copied into its entry's static
    inputs on the executor's one stream, after the previous replay of
    that entry has read them, and its solution leaves the static output
    for a pinned buffer of its own before the next replay writes it --
    the stream order keeps two batches of one entry in flight apart.  On
    the CPU an entry is the eager batched function with no static
    buffers, so donation has nothing to reuse and the front does not
    donate; the executor's ``donate=`` still names the entry for the
    synchronous ``run``."""
    from ..core.grid import default_grid
    return default_grid().device.type == "cuda"


class ServeFuture:
    """One streamed completion: resolves with ``(x, doc)``.

    ``doc`` is the unchanged ``serve_result/v1`` (or ``serve_reject/v1``)
    document; ``x`` is the host float64 solution for ``status='ok'``,
    else None.  Thread-safe; callbacks added after resolution fire
    immediately (on the caller's thread), callbacks added before fire on
    the worker thread as the batch certifies."""

    __slots__ = ("id", "_event", "_doc", "_x", "_callbacks", "_lock")

    def __init__(self):
        self.id: int | None = None       # core request id once admitted
        self._event = threading.Event()
        self._doc = None
        self._x = None
        self._callbacks: list = []
        self._lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        """Block until resolved; returns ``(x, doc)``.  Raises
        ``TimeoutError`` if ``timeout`` elapses first."""
        if not self._event.wait(timeout):
            raise TimeoutError("ServeFuture not resolved within timeout")
        return self._x, self._doc

    def add_done_callback(self, fn) -> None:
        """``fn(future)`` when resolved (immediately if already done)."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    # worker-side -----------------------------------------------------
    def _resolve(self, doc, x) -> None:
        with self._lock:
            if self._event.is_set():
                return                   # first resolution wins
            self._doc, self._x = doc, x
            callbacks, self._callbacks = self._callbacks, []
            self._event.set()
        for fn in callbacks:
            try:
                fn(self)
            except Exception:
                _metrics.inc("serve_callback_errors", op="future")


class _Submission:
    """One enqueued submit (plain struct; also the wake-up sentinel when
    ``future is None``)."""

    __slots__ = ("op", "A", "B", "deadline", "future", "tenant", "trace")

    def __init__(self, op=None, A=None, B=None, deadline=None, future=None,
                 tenant=None, trace=None):
        self.op, self.A, self.B = op, A, B
        self.deadline, self.future = deadline, future
        self.tenant = tenant
        self.trace = trace


class AsyncSolverService:
    """See module docstring.  Wraps a fresh :class:`SolverService` built
    from ``**core_kw`` (or the caller's ``service=``); ``donate=``
    controls buffer donation on the batch path.  The worker thread
    starts immediately and is joined by :meth:`shutdown`."""

    def __init__(self, service: SolverService | None = None, *,
                 donate: bool = True, poll_s: float = POLL_S,
                 autostart: bool = True, depth: int = 2, **core_kw):
        if service is None:
            core_kw.setdefault("pipeline_depth", max(int(depth), 1))
            service = SolverService(**core_kw)
        self.service = service
        self.donate = bool(donate) and donation_safe()
        self.poll_s = float(poll_s)
        #: batches kept dispatched before collecting the oldest: 2 = the
        #: classic double buffer, k > 2 = deep pipelining
        self.depth = max(int(depth), 1)
        self._qin: queue.Queue = queue.Queue()
        self._futures: dict = {}         # core request id -> ServeFuture
        self._settled: list = []         # worker-appended (id, doc) ledger
        self._stop = False               # accept no new submissions
        self._drain = True               # drain queues on stop?
        self._busy_s = 0.0               # device-busy seconds (collected)
        self._t_start = None             # first-batch worker timestamp
        self._t_last = None
        self._t_ready = None             # previous batch's ready time
        self.service.on_result = self._on_result
        # thread name carries the grid for the per-worker export tracks;
        # leak checks match by the shared prefix
        wname = "elemental-serve-worker"
        if self.service.name:
            wname += f":{self.service.name}"
        self._worker = threading.Thread(
            target=self._run, name=wname, daemon=True)
        if autostart:
            self._worker.start()

    def start(self) -> None:
        """Start the worker (no-op if already running).  ``autostart=
        False`` + explicit start lets deterministic harnesses (chaos)
        pre-load the submission queue so batch membership is fixed."""
        if self._worker.ident is None:
            self._worker.start()

    # ---- client side -------------------------------------------------
    def submit(self, op: str, A, B, *, budget_s: float | None = None,
               deadline: Deadline | None = None,
               callback=None, tenant: str | None = None,
               trace: RequestTrace | None = None) -> ServeFuture:
        """Enqueue one request; returns its :class:`ServeFuture`.

        Rejections (load shed, expired deadline, open breaker, bad
        request, shutdown) resolve the future with the structured
        ``serve_reject/v1`` -- nothing raises.  The deadline clock
        starts HERE (submit time), not at worker ingest -- and so does
        the lifecycle timeline: ``submitted`` is stamped on the CALLER's
        thread (a fleet passes its own ``trace``, already stamped)."""
        fut = ServeFuture()
        if callback is not None:
            fut.add_done_callback(callback)
        if deadline is None and budget_s is not None:
            deadline = Deadline(budget_s, clock=self.service.clock)
        if trace is None:
            trace = RequestTrace(clock=self.service.clock, tenant=tenant,
                                 op=op, flight=self.service.flight)
            trace.mark("submitted", op=op)
        if self._stop:
            _metrics.inc("serve_rejects", reason="shutdown")
            fut._resolve(reject_doc("shutdown", deadline=deadline,
                                    grid=self.service.name, tenant=tenant,
                                    detail="async service has shut down",
                                    trace=trace),
                         None)
            return fut
        self._qin.put(_Submission(op, A, B, deadline, fut, tenant, trace))
        _metrics.set_gauge("serve_async_submit_queue", self._qin.qsize())
        return fut

    def shutdown(self, drain: bool = True) -> dict:
        """Stop the service and JOIN the worker (no thread leak).

        ``drain=True`` finishes everything queued through the normal
        pipeline first; ``drain=False`` flushes queued work with
        structured shutdown rejects (the batch already on device still
        completes).  Returns ``{id: doc}`` for every ADMITTED request
        settled by this call; never-admitted submissions still resolve
        their futures with shutdown rejects.  Idempotent."""
        n0 = len(self._settled)
        self._drain = bool(drain)
        self._stop = True
        self._qin.put(_Submission())     # wake the worker
        self.start()                     # autostart=False: drain now
        if self._worker.is_alive():
            self._worker.join()
        done = dict(self._settled[n0:])
        self._gauges(inflight=0)
        return done

    def results(self) -> dict:
        """The core's ``{id: doc}`` ledger (resolved requests only)."""
        return self.service.results

    def pipeline_stats(self) -> dict:
        """Occupancy counters: device-busy seconds over worker
        wall-clock since the first batch (1.0 = device never idle)."""
        wall = 0.0
        if self._t_start is not None and self._t_last is not None:
            wall = max(self._t_last - self._t_start, 0.0)
        occ = self._busy_s / wall if wall > 0 else 0.0
        return {"device_busy_s": self._busy_s, "wall_s": wall,
                "occupancy": occ}

    # ---- worker side -------------------------------------------------
    def _on_result(self, rid: int, doc: dict, x) -> None:
        self._settled.append((rid, doc))
        fut = self._futures.pop(rid, None)
        if fut is not None:
            fut._resolve(doc, x)

    def _gauges(self, inflight: int) -> None:
        _metrics.set_gauge("serve_async_submit_queue", self._qin.qsize())
        _metrics.set_gauge("serve_async_inflight", inflight)
        stats = self.pipeline_stats()
        _metrics.set_gauge("serve_pipeline_occupancy", stats["occupancy"])

    def _ingest(self, block: bool) -> None:
        """Move submissions from the thread-safe queue into the core
        (admission runs HERE, on the worker thread -- the core is
        single-threaded by construction)."""
        svc = self.service
        first = True
        while True:
            try:
                sub = self._qin.get(
                    timeout=self.poll_s if block and first else None) \
                    if block and first else self._qin.get_nowait()
            except queue.Empty:
                return
            first = False
            if sub.future is None:
                continue                 # wake-up sentinel
            if self._stop and not self._drain:
                self._flush_submission(sub)
                continue
            out = svc.submit(sub.op, sub.A, sub.B, deadline=sub.deadline,
                             tenant=sub.tenant, trace=sub.trace)
            if isinstance(out, dict):    # structured fast reject
                sub.future._resolve(out, None)
            else:
                sub.future.id = out
                self._futures[out] = sub.future

    def _flush_submission(self, sub) -> None:
        """Resolve a never-admitted submission with a shutdown reject
        (the drain=False path: zero silent drops)."""
        _metrics.inc("serve_rejects", reason="shutdown")
        sub.future._resolve(
            reject_doc("shutdown", deadline=sub.deadline,
                       grid=self.service.name, tenant=sub.tenant,
                       detail="flushed by shutdown(drain=False)",
                       trace=sub.trace), None)

    def _stage_next(self):
        """Pop + prepare + stage + DISPATCH the next batch (returns the
        in-flight (bucket, staged) pair, or None).  Preparation may
        settle requests inline (drops / escalations / grid routing) --
        those stream immediately and the next queued batch is tried."""
        svc = self.service
        while True:
            popped = svc._pop_batch()
            if popped is None:
                return None
            bucket, batch = popped
            live = svc._prepare_batch(bucket, batch)
            if live:
                break
        staged = svc.executor.stage(bucket, live, donate=self.donate)
        svc.executor.dispatch(staged)
        if self._t_start is None:
            # from the first dispatch's START: an eager entry (the CPU,
            # 'lu' on the card) computes inside dispatch
            self._t_start = staged.t0
        return bucket, staged

    def _collect(self, inflight) -> None:
        """Block for the in-flight batch and run the completion leg
        (certify -> breaker -> isolate); futures resolve via
        ``on_result`` inside ``_finalize``."""
        svc = self.service
        bucket, staged = inflight
        t0 = staged.t0
        xs, seconds = svc.executor.collect(staged)
        # dispatch->ready includes time queued BEHIND the previous batch
        # (double buffering enqueues early); device-busy time for the
        # occupancy gauge starts when the device actually picked it up
        ready = t0 + seconds
        start = t0 if self._t_ready is None else max(t0, self._t_ready)
        self._busy_s += max(ready - start, 0.0)
        self._t_ready = ready
        self._t_last = svc.clock()
        svc._complete_batch(bucket, staged.requests, xs, seconds)

    def _run(self) -> None:
        import collections
        svc = self.service
        pipeline: collections.deque = collections.deque()
        while True:
            stopping = self._stop
            self._ingest(block=(not pipeline and not stopping
                                and not svc._queues))
            if self._stop and not self._drain:
                # emergency stop: let the device finish what it holds,
                # flush everything else with structured rejects
                while pipeline:
                    self._collect(pipeline.popleft())
                self._ingest(block=False)
                svc_done = svc.shutdown(drain=False)
                for rid, doc in svc_done.items():
                    self._on_result(rid, doc, None)
                self._gauges(inflight=0)
                return
            # depth-k pipeline: stage + dispatch until ``depth`` batches
            # are in flight BEFORE collecting the oldest -- the device
            # queue serializes them, so the device goes batch to batch
            # while the host stages and collects in its shadow.  depth=2
            # is the double buffer's event order (stage k+1, collect k,
            # stage k+2, collect k+1, ...).
            while len(pipeline) < self.depth:
                nxt = self._stage_next()
                if nxt is None:
                    break
                pipeline.append(nxt)
            if pipeline:
                self._collect(pipeline.popleft())
            self._gauges(inflight=len(pipeline))
            if not pipeline and not svc._queues \
                    and self._qin.empty() and stopping:
                svc.shutdown(drain=True)     # idempotent: marks core
                self._gauges(inflight=0)
                return


def serve_async(requests, *, donate: bool = True,
                **core_kw) -> tuple:
    """One-shot convenience: pump ``(op, A, B)`` triples through a fresh
    async service, wait for every completion, shut down cleanly.
    Returns ``(docs, xs)`` lists in submission order."""
    front = AsyncSolverService(donate=donate, **core_kw)
    futures = [front.submit(op, A, B) for (op, A, B) in requests]
    out = [f.result() for f in futures]
    front.shutdown(drain=True)
    return [doc for _, doc in out], [x for x, _ in out]
