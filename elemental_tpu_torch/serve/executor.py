"""Batched bucket executor: batched library solves + a persistent cache
of captured CUDA graphs.

PyTorch port of ``elemental_tpu/serve/executor.py``.  The throughput
core of the solver service.  All requests in one
:class:`~.admission.Bucket` are PADDED to the bucket's canonical geometry
(the system embedded top-left, identity on the padded diagonal, zero
right-hand sides -- the padded solution's extra rows are exactly zero,
so truncation is lossless), stacked, and solved by ONE batched call:
hundreds of small systems amortize one launch sequence.  The batched
solve is PyTorch's batched ``torch.linalg`` routines, as the JAX package
leaves its ``vmap``'d solve to XLA's library routines; the hand-written
kernels run where a request leaves this path (``service.py``'s
escalation and the tuner-fed ``'grid'`` route).

The batch path is split into three stages so an async front-end can
overlap them across batches:

  * :meth:`Executor.stage`    -- host work: pad/stack into PINNED host
    buffers, entry lookup, and the host-to-device copy into the entry's
    static inputs (``non_blocking`` on the executor's stream)
  * :meth:`Executor.dispatch` -- device launch: replays the entry's
    graph, queues the solution's copy into a pinned host buffer and
    records a ``torch.cuda.Event``; returns WITHOUT a sync, so the host
    is free to stage batch k+1 while batch k runs
  * :meth:`Executor.collect`  -- waits on the event + fault seam + host
    truncation + certifiable float64 slices

``Executor.run`` is the synchronous composition of the three.

Every device operation of an executor -- the input copies, the replay,
the read-back -- is queued on the executor's ONE stream, in the order
the host issues them.  A captured graph has one set of static buffers;
the stream order is what lets batch k+1 be staged into them while batch
k is still in flight: k+1's input copy runs after k's replay has read
the inputs, and k's solution leaves the static output (into k's own
pinned host buffer) before k+1's replay writes it.

No request pays a capture: an entry is captured ONCE per ``(op,
bucket, batch-slot, dtype, backend, tuner-provenance, donation)`` key --
the geometry part is the same key vocabulary as ``tuning_cache/v1``, and
the key string is the JAX package's byte for byte -- and cached for the
life of the process (``serve_exec_cache/v1``; hits/misses/captures are
counted on the obs metrics registry as ``serve_exec_cache_events``,
where ``compile`` counts a capture).  Batch sizes are pow2-bucketed too
(``batch_slots``), so a queue draining 3, 5, then 6 requests reuses the
4- and 8-slot entries.  The tuner-provenance component (:func:`tune_token`)
is a digest of the resolved tuning-cache winner for the mapped driver
op, so a tuner re-sweep (every ``tune.cache.save``/``clear`` bumps the
in-process epoch) can never serve a stale entry.

Which ops are captured is decided per op in code (:data:`GRAPH_OPS`),
from what was established on the card, and stated in
:meth:`ExecutableCache.stats`; an op that is not captured runs its
eager batched call on the executor's stream.  On a CPU device every
entry is the eager batched function and the counters behave the same.

Dispatch is tuner-fed (:func:`route_for`): when the tuning cache holds a
MEASURED winner for the mapped distributed driver whose seconds beat the
batch path's per-request estimate, the request leaves the batch path for
the grid path -- and either way the decision lands in
``serve_result/v1`` provenance.

The batch output routes through the engine's ``'compute'`` fault seam
(:func:`~elemental_tpu_torch.redist.engine.apply_fault`) before
certification, so chaos tests can model a soft error in the batched
local math -- the serve-side twin of the driver panel seams.

Certification is the same TRUSTED measurement ``certified_solve`` uses:
host-side float64 residuals per request (a corrupted executor can
corrupt the solve, never the measurement).  Least-squares requests
certify on the normal-equations residual (:func:`ls_residual`), which
vanishes at the LS minimizer even when ``B - A X`` cannot.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
import zlib

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..redist.engine import apply_fault
from ..tune import cache as _tune
from .admission import Bucket

EXEC_SCHEMA = "serve_exec_cache/v1"

#: serve op -> distributed-driver op in the ``tuning_cache/v1`` vocabulary
#: (what :func:`tune_token` digests and :func:`route_for` consults)
DRIVER_OPS = {"hpd": "cholesky", "lu": "lu", "lstsq": "qr"}

#: ops whose batched solve is captured as a CUDA graph on the card.  On an
#: H100 (torch 2.11, CUDA 12.8) the batched Cholesky + triangular solves
#: and the batched reduced QR + triangular solve captured at every serve
#: geometry tried (n = 16 ... 4096, 1 ... 8 slots, f32 and f64), each
#: replay bit-equal to its eager call.  The batched LU did not: above
#: n = 128 at several slot counts ``lu_factor_ex`` takes MAGMA's batched
#: getrf, which synchronizes with the host and invalidates the capture.
#: So 'lu' runs its eager batched call on the executor's stream, at every
#: size (``tests/test_torch_gpu.py``'s ``test_serve_entries_capture_per_op``
#: and ``test_serve_lu_batch_cannot_be_captured`` pin this on the card).
GRAPH_OPS = frozenset({"hpd", "lstsq"})


class _CaptureGate:
    """Captures exclude every other serve-layer device call in the
    process.

    Fleet members work from their own threads.  On an H100 a member's
    eager batched LU (MAGMA) failed with "operation not permitted when
    stream is capturing" while another member captured, and invalidated
    that capture, though the capture was thread-local.  So the
    executors' device sections hold the gate :meth:`shared` (any number
    at once), and a capture holds it :meth:`exclusive` -- it waits for
    the shared holders to leave, and new ones wait behind it.  Every
    escalation holds it :meth:`exclusive` too: the distributed drivers
    capture CUDA graphs of their own in the global capture mode (CALU's
    pivot sweeps, the 'fast' rungs of an 'lu' escalation on a member's
    2x2 virtual grid), which no other thread's eager batched LU or event
    wait may run beside.  Shared sections do not nest a capture; a thread
    re-entering :meth:`shared` passes a waiting capture, and the thread
    that holds the gate exclusive passes both :meth:`shared` and
    :meth:`exclusive`.  Device work outside the serve layer is not
    gated."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = None          # the thread that holds it exclusive
        self._waiting = 0
        self._local = threading.local()

    @contextlib.contextmanager
    def shared(self):
        if self._writer is threading.current_thread():
            yield
            return
        depth = getattr(self._local, "depth", 0)
        with self._cond:
            while self._writer is not None or (self._waiting and depth == 0):
                self._cond.wait()
            self._readers += 1
        self._local.depth = depth + 1
        try:
            yield
        finally:
            self._local.depth = depth
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.current_thread()
        if self._writer is me:
            yield
            return
        if getattr(self._local, "depth", 0):
            raise RuntimeError("a capture inside a shared device section "
                               "would wait for itself")
        with self._cond:
            self._waiting += 1
            while self._writer is not None or self._readers:
                self._cond.wait()
            self._waiting -= 1
            self._writer = me
        try:
            yield
        finally:
            with self._cond:
                self._writer = None
                self._cond.notify_all()


#: the process's gate between captures and the rest of the serve layer's
#: device work (see :class:`_CaptureGate`)
DEVICE_GATE = _CaptureGate()


def batch_slots(k: int) -> int:
    """Pow2 slot count for a batch of ``k`` requests (>= 1)."""
    k = max(int(k), 1)
    return 1 << (k - 1).bit_length()


def pad_problem(A: np.ndarray, B: np.ndarray, bucket: Bucket):
    """Embed one (n, n) system into the bucket's canonical geometry.

    Returns ``(Ap, Bp)`` with ``Ap = [[A, 0], [0, I]]`` (nonsingular and
    HPD-preserving by construction) and ``Bp = [[B], [0]]`` zero-padded
    on both dims, so ``Xp[:n, :nrhs]`` IS the original solution."""
    n, nrhs = A.shape[0], B.shape[1]
    dt = np.dtype(bucket.dtype)
    Ap = np.eye(bucket.n, dtype=dt)
    Ap[:n, :n] = A
    Bp = np.zeros((bucket.n, bucket.nrhs), dtype=dt)
    Bp[:n, :nrhs] = B
    return Ap, Bp


def pad_problem_ls(A: np.ndarray, B: np.ndarray, bucket: Bucket):
    """Embed one (m, n) least-squares problem into the bucket geometry.

    ``Ap[:m, :n] = A`` and an identity block fills the EXTRA columns in
    the EXTRA rows: ``Ap[m : m + (N - n), n:] = I``.  The pad columns
    are therefore orthogonal to A's columns, the padded normal equations
    decouple, and ``Xp[:n]`` is exactly the original LS minimizer
    (``Xp[n:] = 0`` since the pad rows of B are zero).  ``make_bucket``
    guarantees ``M >= m + (N - n)`` so the identity always fits."""
    m, n = A.shape
    nrhs = B.shape[1]
    dt = np.dtype(bucket.dtype)
    N, M = bucket.n, bucket.m
    Ap = np.zeros((M, N), dtype=dt)
    Ap[:m, :n] = A
    if N > n:
        Ap[m:m + (N - n), n:] = np.eye(N - n, dtype=dt)
    Bp = np.zeros((M, bucket.nrhs), dtype=dt)
    Bp[:m, :nrhs] = B
    return Ap, Bp


def _solve_lu(a, b):
    # the ``_ex`` forms leave ``info`` on the device (their plain twins
    # read it back to the host).  Identity padding keeps every slot
    # nonsingular, so ``info`` is 0 on every slot, as in the JAX package
    LU, piv, _ = torch.linalg.lu_factor_ex(a)
    return torch.linalg.lu_solve(LU, piv, b)


def _solve_hpd(a, b):
    L, _ = torch.linalg.cholesky_ex(a)
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mH, y, upper=True)


def _solve_lstsq(a, b):
    q, r = torch.linalg.qr(a, mode="reduced")
    return torch.linalg.solve_triangular(r, q.mH @ b, upper=True)


_SOLVES = {"lu": _solve_lu, "hpd": _solve_hpd, "lstsq": _solve_lstsq}


def _kernel(op: str):
    """The batched solve ``(A, B) -> X`` over a ``(slots, rows, n)``
    batch: the JAX package's vmapped one-problem kernel, written with
    the batch dimension out."""
    fn = _SOLVES.get(op)
    if fn is None:
        raise ValueError(
            f"executor op must be 'lu', 'hpd' or 'lstsq', got {op!r}")
    return fn


def _bucket_dims(bucket: Bucket) -> tuple:
    return (bucket.m, bucket.n) if bucket.m is not None \
        else (bucket.n, bucket.n)


def batch_peak_bytes(bucket: Bucket, slots: int) -> int:
    """Closed-form peak device bytes of ONE ``slots``-wide batch of this
    bucket: the batch's operands and the buffers its batched solve holds
    at its peak -- no device execution.  Feeds the admission
    controller's memory-pressure shed decision.

    Per slot, in elements of the bucket's dtype (``rows = m`` for
    lstsq, else ``n``):

      * ``lu``:    A and B, the packed factor (A), the solution and its
        row-permuted right-hand side (2 B), the pivots and the getrs
        workspace (one column of int32 pivots as elements, one B);
      * ``hpd``:   A and B, the factor L and the column-major working
        copy the batched potrf factors in, the conjugate transpose the
        backward solve reads and the potrf workspace (4 A), the forward
        and backward solutions and their working copies (3 B);
      * ``lstsq``: A and B, the reduced Q and the packed reflectors the
        QR builds it from (2 A), R (n x n), Q^H B and the solution
        (2 n x nrhs), B's working copy.

    The static buffers of a captured entry are the operands and the
    solution; the rest lives in its graph's private pool.  Held at or
    above the JAX package's liveness walk of its vmapped kernel and
    within 2x of it by the CPU tests."""
    rows, n = _bucket_dims(bucket)
    k = bucket.nrhs
    z = np.dtype(bucket.dtype).itemsize
    a, b = rows * n, rows * k
    if bucket.op == "lu":
        elems = 2 * a + 4 * b + n
    elif bucket.op == "hpd":
        elems = 5 * a + 4 * b
    elif bucket.op == "lstsq":
        elems = 3 * a + 2 * b + n * n + 2 * n * k
    else:
        raise ValueError(f"no peak formula for op {bucket.op!r}")
    return int(slots) * int(elems) * z


#: memoized tuner-provenance tokens: (cache_dir, driver_op, dims, dtype,
#: backend) -> (tune-cache epoch, token).  Recomputed only when the
#: in-process tuning-cache write generation moves (a re-sweep
#: invalidates without a file read per batch).
_TOKEN_MEMO: dict = {}


def tune_token(op: str, bucket: Bucket, backend: str, ns: str = "") -> str:
    """Digest of the resolved tuning-cache winner for this geometry.

    Empty string when the mapped driver op has no cache entry (the
    common cold case -- entry keys stay the plain geometry).  Otherwise
    a crc32 over the winner's config/created/source, so any re-sweep
    that changes the resolved knobs changes the entry key and forces a
    fresh capture instead of serving a stale one.  ``ns`` scopes the
    lookup to a fleet member's namespaced entries: two pool grids can
    resolve DIFFERENT winners."""
    driver_op = DRIVER_OPS.get(op)
    if driver_op is None:
        return ""
    dims = _bucket_dims(bucket)
    memo_key = (_tune.cache_dir(), driver_op, dims, bucket.dtype, backend,
                ns)
    ep = _tune.epoch()
    cached = _TOKEN_MEMO.get(memo_key)
    if cached is not None and cached[0] == ep:
        return cached[1]
    doc = _tune.load(
        _tune.make_key(driver_op, dims, bucket.dtype, (1, 1), backend,
                       ns=ns))
    if doc is None:
        token = ""
    else:
        blob = json.dumps(
            [doc.get("config"), doc.get("created"), doc.get("source")],
            sort_keys=True)
        token = format(zlib.crc32(blob.encode()), "08x")
    _TOKEN_MEMO[memo_key] = (ep, token)
    return token


def route_for(bucket: Bucket, grid_shape, backend: str,
              est_vmap_s: float | None, ns: str = ""):
    """Tuner-fed dispatch decision for ONE request of ``bucket``.

    Returns ``(route, provenance)`` with route ``'vmap'`` (the batched
    path; the name is the JAX package's) or ``'grid'`` (the distributed
    driver path).  The request leaves the batch path ONLY when the
    tuning cache holds a MEASURED winner for the mapped driver op at this
    geometry on ``grid_shape`` whose recorded seconds strictly beat the
    batch path's per-request estimate (``est_vmap_s``, the admission
    EWMA / cold flops model) -- a missing or unmeasured entry always
    stays on the batch path, so routing is deterministic on a cold
    cache.  ``ns`` scopes the lookup to a fleet member's namespaced
    constants.  The provenance dict is what ``serve_result/v1`` records
    as its ``dispatch`` field."""
    driver_op = DRIVER_OPS.get(bucket.op)
    prov = {"route": "vmap", "driver_op": driver_op,
            "grid": list(grid_shape), "source": "default",
            "tune_token": "", "measured_s": None,
            "vmap_est_s": None if est_vmap_s is None else float(est_vmap_s)}
    if driver_op is None:
        return "vmap", prov
    prov["tune_token"] = tune_token(bucket.op, bucket, backend, ns=ns)
    doc = _tune.load(_tune.make_key(driver_op, _bucket_dims(bucket),
                                    bucket.dtype, tuple(grid_shape),
                                    backend, ns=ns))
    if doc is None or doc.get("source") != "measured":
        return "vmap", prov
    prov["source"] = "measured"
    sec = (doc.get("metric") or {}).get("seconds")
    if sec is None:
        return "vmap", prov
    prov["measured_s"] = float(sec)
    if est_vmap_s is not None and float(sec) < float(est_vmap_s):
        prov["route"] = "grid"
        return "grid", prov
    return "vmap", prov


def _backend(device: torch.device) -> str:
    """The backend word of a device (``'gpu'`` / ``'cpu'``), the one the
    tuner's cache file names and machine rows use."""
    return "gpu" if device.type == "cuda" else device.type


def _default_place() -> torch.device:
    from ..core.grid import default_grid
    return default_grid().device


class _Entry:
    """One cached batched solve.

    ``graph`` is None for an eager entry (every CPU entry; an op outside
    :data:`GRAPH_OPS` on the card): :meth:`launch` then calls the batched
    function on the operands it is given.  A captured entry owns static
    input buffers ``a`` / ``b`` and the static output ``x``; :meth:`launch`
    copies operands that are not those buffers into them and replays."""

    __slots__ = ("op", "fn", "graph", "a", "b", "x")

    def __init__(self, op: str, fn, graph=None, a=None, b=None, x=None):
        self.op, self.fn, self.graph = op, fn, graph
        self.a, self.b, self.x = a, b, x

    def launch(self, a, b):
        if self.graph is None:
            return self.fn(a, b)
        if a is not self.a:
            self.a.copy_(a, non_blocking=True)
        if b is not self.b:
            self.b.copy_(b, non_blocking=True)
        self.graph.replay()
        return self.x


def _capture(op: str, slots: int, rows: int, n: int, nrhs: int, dtype,
             device: torch.device, stream) -> _Entry:
    """Capture one batched solve on ``stream`` over static buffers that
    hold a well-posed batch (identity systems) while capturing, with the
    device gate held alone."""
    fn = _kernel(op)
    with DEVICE_GATE.exclusive():
        with torch.cuda.stream(stream):
            a = torch.zeros((slots, rows, n), dtype=dtype, device=device)
            a[:, :n, :] = torch.eye(n, dtype=dtype, device=device)
            b = torch.zeros((slots, rows, nrhs), dtype=dtype, device=device)
            fn(a, b)    # library handles and workspaces before capture
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            x = fn(a, b)
    return _Entry(op, fn, graph, a, b, x)


class ExecutableCache:
    """Captured batched solvers, keyed like ``tuning_cache/v1``.

    One entry per ``(op, bucket, slots, dtype, backend)`` plus -- when
    set -- the resolved tuner-provenance token and the donation flag: a
    re-sweep or a donating front-end gets its OWN entry instead of a
    stale or non-donating one.  The first request of a geometry pays the
    capture ONCE, every later batch replays it.  In-process persistent.

    ``place`` is the torch device the entries run on (the owning
    executor's; the default grid's device until one is set) and
    ``stream`` the stream they are captured and replayed on."""

    def __init__(self):
        self._cache: dict = {}
        self.place: torch.device | None = None
        self.stream = None

    def _place(self) -> torch.device:
        if self.place is None:
            self.place = _default_place()
        return self.place

    def _stream(self):
        if self.stream is None:
            self.stream = torch.cuda.Stream(device=self._place())
        return self.stream

    @staticmethod
    def key(op: str, bucket: Bucket, slots: int, backend: str,
            tune: str = "", donate: bool = False,
            device=None) -> str:
        if bucket.m is not None:
            geo = f"b{bucket.m}x{bucket.n}x{bucket.nrhs}"
        else:
            geo = f"b{bucket.n}x{bucket.nrhs}"
        key = f"{op}__{geo}__x{slots}__{bucket.dtype}__{backend}"
        if tune:
            key += f"__t{tune}"
        if donate:
            key += "__donated"
        if device is not None:
            # fleet members pin their batches to their lead rank slot:
            # one entry per pinned placement; the unpinned key stays
            # the plain one
            key += f"__d{device.id}"
        return key

    def get(self, op: str, bucket: Bucket, slots: int, *,
            donate: bool = False, device=None, tune_ns: str = ""):
        """The cached batched entry for this geometry (captured on first
        use).

        ``device`` is a fleet member's lead rank slot: it only names the
        entry (``__d{id}``); the entry runs on :attr:`place`.
        ``tune_ns`` scopes the tuner-provenance token to the member's
        namespaced constants."""
        place = self._place()
        backend = _backend(place)
        key = self.key(op, bucket, slots, backend,
                       tune=tune_token(op, bucket, backend, ns=tune_ns),
                       donate=donate, device=device)
        hit = self._cache.get(key)
        if hit is not None:
            _metrics.inc("serve_exec_cache_events", op=op, event="hit")
            return hit
        _metrics.inc("serve_exec_cache_events", op=op, event="miss")
        rows = bucket.m if bucket.m is not None else bucket.n
        if place.type == "cuda" and op in GRAPH_OPS:
            dtype = getattr(torch, np.dtype(bucket.dtype).name)
            entry = _capture(op, int(slots), rows, bucket.n, bucket.nrhs,
                             dtype, place, self._stream())
        else:
            entry = _Entry(op, _kernel(op))
        _metrics.inc("serve_exec_cache_events", op=op, event="compile")
        self._cache[key] = entry
        return entry

    def stats(self) -> dict:
        return {"schema": EXEC_SCHEMA, "entries": sorted(self._cache),
                "graphs": sorted(k for k, e in self._cache.items()
                                 if e.graph is not None),
                "graph_ops": sorted(GRAPH_OPS)
                if self._place().type == "cuda" else []}

    def clear(self) -> None:
        self._cache.clear()


@dataclasses.dataclass
class Staged:
    """One staged batch in flight: padded operands + its entry.

    Produced by :meth:`Executor.stage`; :meth:`Executor.dispatch` fills
    ``X``/``t0``/``ready`` (and drops the operand references when they
    were donated -- they belong to the entry afterwards);
    :meth:`Executor.collect` consumes it.  ``host`` keeps the pinned
    staging buffers alive until their copies have run."""
    bucket: Bucket
    requests: list
    compiled: object
    a: object
    b: object
    donate: bool
    X: object = None
    t0: float = 0.0
    host: tuple = ()
    ready: object = None


class Executor:
    """Runs padded batches through the cached entries.

    ``run`` is the synchronous path; the async front drives the same
    three stages itself so batch k+1's host staging overlaps batch k's
    device execution.  ``device``/``tune_ns`` name a fleet member's
    entries after its lead rank slot and scope its tuner provenance to
    the member's constant namespace.  :attr:`place` is the torch device
    the batches run on (the service's grid's device; the default grid's
    until set)."""

    def __init__(self, *, clock=time.monotonic, device=None,
                 tune_ns: str = ""):
        self.cache = ExecutableCache()
        self.clock = clock
        self.device = device
        self.tune_ns = str(tune_ns)

    @property
    def place(self) -> torch.device:
        return self.cache._place()

    @place.setter
    def place(self, device) -> None:
        self.cache.place = torch.device(device)

    @staticmethod
    def _mark(staged: "Staged", edge: str, **attrs) -> None:
        """Lifecycle edge on every request of the batch."""
        for req in staged.requests:
            tr = getattr(req, "trace", None)
            if tr is not None:
                tr.mark(edge, batch=len(staged.requests), **attrs)

    def stage(self, bucket: Bucket, requests, *, donate: bool = False):
        """HOST stage: pad + stack every request into pinned buffers,
        look up the entry, queue the copies to the device.

        This is the work the async pipeline overlaps with the previous
        batch's device execution.  A donated batch is copied straight
        into the entry's static inputs (they belong to the batch until
        its replay); otherwise into device buffers of its own.  Returns a
        :class:`Staged`."""
        t0 = self.clock()
        k = len(requests)
        slots = batch_slots(k)
        dt = np.dtype(bucket.dtype)
        place = self.place
        cuda = place.type == "cuda"
        tdt = getattr(torch, dt.name)
        rows = bucket.m if bucket.m is not None else bucket.n
        compiled = self.cache.get(bucket.op, bucket, slots, donate=donate,
                                  device=self.device, tune_ns=self.tune_ns)
        # pinning host memory is a CUDA call: not beside an escalation's
        # global-mode capture
        with DEVICE_GATE.shared() if cuda else contextlib.nullcontext():
            ha = torch.empty((slots, rows, bucket.n), dtype=tdt,
                             pin_memory=cuda)
            hb = torch.empty((slots, rows, bucket.nrhs), dtype=tdt,
                             pin_memory=cuda)
        a, b = ha.numpy(), hb.numpy()
        if bucket.m is not None:
            a[...] = 0
            a[:, :bucket.n, :] = np.eye(bucket.n, dtype=dt)
            b[...] = 0
            for i, req in enumerate(requests):
                a[i], b[i] = pad_problem_ls(req.A, req.B, bucket)
        else:
            a[...] = np.eye(bucket.n, dtype=dt)
            b[...] = 0
            for i, req in enumerate(requests):
                a[i], b[i] = pad_problem(req.A, req.B, bucket)
        if not cuda:
            da, db = ha, hb
        else:
            with DEVICE_GATE.shared(), \
                    torch.cuda.stream(self.cache._stream()):
                if donate and compiled.graph is not None:
                    da, db = compiled.a, compiled.b
                else:
                    da = torch.empty(ha.shape, dtype=tdt, device=place)
                    db = torch.empty(hb.shape, dtype=tdt, device=place)
                da.copy_(ha, non_blocking=True)
                db.copy_(hb, non_blocking=True)
        staged = Staged(bucket=bucket, requests=list(requests),
                        compiled=compiled, a=da, b=db, donate=donate,
                        host=(ha, hb) if cuda else ())
        _metrics.observe("serve_stage_seconds", self.clock() - t0,
                         op=bucket.op, stage="stage")
        self._mark(staged, "staged", slots=slots)
        return staged

    def dispatch(self, staged: Staged) -> Staged:
        """DEVICE launch: returns as soon as the work is queued -- the
        host is free to stage the next batch.  On the card the solution
        is copied out of the entry (into a pinned host buffer of the
        batch's own) on the same stream, and an event marks it ready."""
        t0 = self.clock()
        staged.t0 = t0
        entry = staged.compiled
        if self.place.type != "cuda":
            staged.X = entry.launch(staged.a, staged.b)
        else:
            from ..core.environment import check_precision
            check_precision(None, staged.a)
            stream = self.cache._stream()
            with DEVICE_GATE.shared(), torch.cuda.stream(stream):
                X = entry.launch(staged.a, staged.b)
                out = torch.empty(X.shape, dtype=X.dtype, pin_memory=True)
                out.copy_(X, non_blocking=True)
                staged.ready = torch.cuda.Event()
                staged.ready.record(stream)
            staged.X = out
        if staged.donate:
            staged.a = staged.b = None       # donated: owned by the entry
        _metrics.observe("serve_stage_seconds", self.clock() - t0,
                         op=staged.bucket.op, stage="dispatch")
        self._mark(staged, "dispatched")
        return staged

    def collect(self, staged: Staged):
        """Wait for the device result, cross the fault seam, truncate.

        Returns ``(xs, seconds)``: ``xs[i]`` is request i's UNPADDED
        host solution (float64); ``seconds`` the dispatch->ready time on
        the executor's clock (what the admission EWMA feeds on)."""
        bucket, requests = staged.bucket, staged.requests
        if staged.ready is not None:
            with DEVICE_GATE.shared():
                staged.ready.synchronize()
        seconds = self.clock() - staged.t0
        t1 = self.clock()
        X, = apply_fault("compute", (staged.X,))
        # OWNED copy, never a zero-copy view: ``.numpy()`` of a CPU
        # tensor aliases its storage, which is recycled by a later batch
        # (the pinned read-back buffer, the allocator's blocks) --
        # already-resolved solutions would silently mutate under the
        # pipelined front
        Xh = np.array(X.numpy(), dtype=np.float64)
        staged.X = staged.host = staged.ready = None
        # the padded solution is (bucket.n, bucket.nrhs) for every op --
        # lstsq included (QR of the (M, N) pad yields an (N, nrhs) X);
        # a request's true solution is its A's COLUMN count deep
        xs = [Xh[i, :req.A.shape[1], :req.nrhs]
              for i, req in enumerate(requests)]
        _metrics.inc("serve_batches", op=bucket.op)
        _metrics.inc("serve_batched_solves", len(requests), op=bucket.op)
        _metrics.observe("serve_stage_seconds", self.clock() - t1,
                         op=bucket.op, stage="collect")
        self._mark(staged, "collected", seconds=seconds)
        return xs, seconds

    def run(self, bucket: Bucket, requests, *, donate: bool = False):
        """Solve every request of one bucket in ONE batched dispatch
        (synchronous stage -> dispatch -> collect composition)."""
        if len(requests) == 0:
            return [], 0.0
        return self.collect(self.dispatch(
            self.stage(bucket, requests, donate=donate)))


def residual(A: np.ndarray, B: np.ndarray, X: np.ndarray) -> float:
    """TRUSTED host-float64 normwise relative backward error -- the same
    certificate measurement ``resilience.certify`` uses, computed from
    the caller-held problem data (never the executor's arrays)."""
    An = np.asarray(A, dtype=np.float64)
    Bn = np.asarray(B, dtype=np.float64)
    Xn = np.asarray(X, dtype=np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        den = (np.linalg.norm(An) * np.linalg.norm(Xn)
               + np.linalg.norm(Bn))
        if not np.isfinite(den) or den == 0.0:
            return float("inf")
        res = np.linalg.norm(Bn - An @ Xn) / den
    return float(res) if np.isfinite(res) else float("inf")


def ls_residual(A: np.ndarray, B: np.ndarray, X: np.ndarray) -> float:
    """TRUSTED host-float64 least-squares certificate: the scaled
    normal-equations residual ``|A' (B - A X)| / (|A|^2 |X| + |A| |B|)``.
    Unlike the plain residual, this vanishes at the LS minimizer even
    when the overdetermined system leaves ``B - A X`` nonzero."""
    An = np.asarray(A, dtype=np.float64)
    Bn = np.asarray(B, dtype=np.float64)
    Xn = np.asarray(X, dtype=np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        nA = np.linalg.norm(An)
        den = nA * nA * np.linalg.norm(Xn) + nA * np.linalg.norm(Bn)
        if not np.isfinite(den) or den == 0.0:
            return float("inf")
        res = np.linalg.norm(An.conj().T @ (Bn - An @ Xn)) / den
    return float(res) if np.isfinite(res) else float("inf")
