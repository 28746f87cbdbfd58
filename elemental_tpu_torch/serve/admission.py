"""Admission control: shape bucketing, deadlines, and load shedding.

PyTorch port of ``elemental_tpu/serve/admission.py``.  The front door of
the solver service.  Production traffic at the scale the source paper
targets (arXiv 2112.09017) is overwhelmingly many small-to-medium
solves; this module turns an arbitrary stream of ``A x = b`` requests
into a SMALL set of canonical geometries the executor can batch and
capture once:

  * **shape bucketing** -- request dims round up to the tuner's
    power-of-two buckets (:func:`~elemental_tpu_torch.tune.cache.shape_bucket`,
    the SAME bucketing the tuning cache keys on, so serve buckets and
    tuned knob entries line up 1:1);
  * **deadlines** -- every request carries a :class:`Deadline` (budget /
    elapsed / remaining), the object the whole dispatch chain threads:
    the batcher drops expired requests before launch, the executor
    checks it before dispatch, and ``certified_solve(deadline=)`` stops
    the escalation ladder on it;
  * **load shedding** -- when the estimated queue wait for a request's
    bucket (queued batches ahead x the bucket's cost estimate) exceeds
    its remaining budget, the request is rejected FAST with a structured
    ``serve_reject/v1`` document instead of being queued to die: the
    client learns in microseconds, not after the deadline.

Cost estimates are per-bucket EWMAs of measured batch seconds (the
executor reports every batch it runs), seeded cold by a flops/throughput
model -- so shedding is conservative on a cold service and converges to
the observed rate.

All clocks are injectable (``clock=`` on :class:`Deadline` and
:class:`AdmissionController`), which is what makes the chaos/breaker
tests deterministic under replay.  Host-only: nothing here touches a
device except the backend word of the memory budget.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np

from ..tune.cache import shape_bucket

REJECT_SCHEMA = "serve_reject/v1"

#: reject reasons (pinned by the tests).  'shutdown' marks requests
#: flushed by ``SolverService.shutdown`` -- queued work that was NOT
#: executed gets this structured reject instead of being dropped.
#: 'memory_pressure': the bucket's closed-form peak bytes at max_batch
#: do not fit the configured per-device memory.  'quota': the submitting
#: tenant is at its configured max-outstanding limit in the fleet's fair
#: scheduler.
REJECT_REASONS = ("queue_pressure", "deadline_expired", "breaker_open",
                  "bad_request", "shutdown", "memory_pressure", "quota")

#: cold-start throughput assumption for the flops-based cost seed,
#: flop/s.  Deliberately modest (CPU-class): a cold service sheds
#: conservatively and the EWMA takes over after the first batch.
COLD_FLOPS_PER_S = 2.0e9

#: EWMA smoothing for measured batch seconds
EWMA_ALPHA = 0.4


class Deadline:
    """A wall-clock budget: ``budget`` seconds from construction.

    The request-scoped object the service propagates through dispatch
    (admission -> batcher -> executor -> escalation); duck-typed by
    ``certified_solve(deadline=)`` which only needs :meth:`remaining`.
    ``clock`` is injectable for deterministic tests (default
    ``time.monotonic``)."""

    __slots__ = ("budget", "clock", "start")

    def __init__(self, budget: float, clock=time.monotonic):
        self.budget = float(budget)
        self.clock = clock
        self.start = clock()

    def elapsed(self) -> float:
        return self.clock() - self.start

    def remaining(self) -> float:
        return self.budget - self.elapsed()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def to_doc(self) -> dict:
        return {"budget_s": self.budget, "elapsed_s": self.elapsed(),
                "remaining_s": self.remaining()}

    def __repr__(self):
        return (f"Deadline(budget={self.budget:.3g}s, "
                f"remaining={self.remaining():.3g}s)")


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One canonical serve geometry: (op, padded dims, dtype).

    Square solves (lu/hpd) carry ``n x nrhs``; tall-skinny least-squares
    requests (``op='lstsq'``) additionally carry ``m`` -- the padded ROW
    count -- so the key/geometry vocabulary stays the square ops' one
    for them (``m is None``)."""
    op: str                      # "lu" | "hpd" | "lstsq"
    n: int                       # pow2-bucketed system size (columns)
    nrhs: int                    # pow2-bucketed right-hand-side count
    dtype: str
    m: int | None = None         # lstsq only: padded row count

    def key(self) -> str:
        """Cache-key string, same style as ``tuning_cache/v1`` filenames."""
        if self.m is not None:
            return f"{self.op}__b{self.m}x{self.n}x{self.nrhs}__{self.dtype}"
        return f"{self.op}__b{self.n}x{self.nrhs}__{self.dtype}"

    def solve_flops(self) -> float:
        """Factor + solve flops of ONE padded problem (the cost seed)."""
        n, k = float(self.n), float(self.nrhs)
        if self.op == "lstsq":
            m = float(self.m)
            return 2.0 * m * n * n + 2.0 * m * n * k   # QR + apply/solve
        factor = (n ** 3) / 3.0 if self.op == "hpd" else 2.0 * (n ** 3) / 3.0
        return factor + 2.0 * n * n * k


def make_bucket(op: str, n: int, nrhs: int, dtype,
                m: int | None = None) -> Bucket:
    """Bucket a concrete request geometry (pow2 per dim, tuner-aligned).

    For ``op='lstsq'`` pass the raw row count ``m``: columns bucket to
    ``N = pow2(n)`` first, rows to ``M = pow2(m + (N - n))`` -- the extra
    ``N - n`` rows are where the executor's identity pad lives (see
    ``executor.pad_problem_ls``), so every request of the bucket embeds
    losslessly whatever its raw shape."""
    bn, brhs = shape_bucket((int(n), max(int(nrhs), 1)))
    if op == "lstsq":
        if m is None:
            raise ValueError("lstsq buckets need the row count m")
        (bm,) = shape_bucket((int(m) + int(bn) - int(n),))
        return Bucket(op=op, n=int(bn), nrhs=int(brhs),
                      dtype=np.dtype(dtype).name, m=int(bm))
    return Bucket(op=op, n=int(bn), nrhs=int(brhs), dtype=np.dtype(dtype).name)


@dataclasses.dataclass
class SolveRequest:
    """One admitted request (host-side problem data + its deadline)."""
    id: int
    op: str                      # "lu" | "hpd" | "lstsq"
    A: np.ndarray                # (n, n) host array; (m, n) for lstsq
    B: np.ndarray                # (n, nrhs) host array
    bucket: Bucket
    deadline: Deadline | None
    submitted: float             # admission clock timestamp
    tenant: str | None = None    # fleet tenant, None = direct
    #: lifecycle timeline: the per-request
    #: ``obs.lifecycle.RequestTrace`` that rides the request through
    #: stage/dispatch/collect/certify; None = untraced
    trace: object = None

    @property
    def n(self) -> int:
        return int(self.A.shape[0])

    @property
    def nrhs(self) -> int:
        return int(self.B.shape[1])


def reject_doc(reason: str, *, bucket: Bucket | None = None,
               queue_depth: int = 0, estimate_s: float | None = None,
               deadline: Deadline | None = None, detail: str = "",
               grid: str | None = None, tenant: str | None = None,
               trace=None) -> dict:
    """A structured fast-reject (``serve_reject/v1``).

    ``grid`` / ``tenant`` attribute the decision to the fleet member that
    made it and the quota bucket it was charged against; both default to
    None for the single-service path (absent == None for old readers).

    ``trace``: the request's lifecycle
    :class:`~elemental_tpu_torch.obs.lifecycle.RequestTrace`, when one
    exists.  The reject closes it -- ``shed`` (with the reason) then the
    terminal ``rejected`` edge -- and the doc gains the ``timeline``
    sub-doc, so rejected requests carry the same end-to-end record
    results do."""
    if reason not in REJECT_REASONS:
        raise ValueError(f"unknown reject reason {reason!r}; "
                         f"expected one of {REJECT_REASONS}")
    doc = {"schema": REJECT_SCHEMA, "reason": reason,
           "bucket": bucket.key() if bucket is not None else None,
           "queue_depth": int(queue_depth),
           "estimate_s": None if estimate_s is None else float(estimate_s),
           "deadline": deadline.to_doc() if deadline is not None else None,
           "detail": detail, "grid": grid, "tenant": tenant,
           "timeline": None}
    if trace is not None:
        trace.annotate(grid=grid, tenant=tenant, bucket=bucket)
        trace.mark("shed", reason=reason)
        trace.mark("rejected")
        doc["timeline"] = trace.to_doc()
    return doc


def validate_problem(op: str, A, B):
    """Canonicalize ONE request: op aliasing, shape/dtype checks, and
    the tuner-aligned bucket.  Returns ``(op, A, B, bucket)`` on success
    or a ``serve_reject/v1`` dict (``reason='bad_request'``) -- the
    validation half of :meth:`AdmissionController.admit`, split out so
    the fleet router can bucket a request BEFORE choosing which grid's
    admission controller will see it."""
    op = "hpd" if op == "cholesky" else op
    op = "lstsq" if op == "qr" else op
    if op not in ("lu", "hpd", "lstsq"):
        return reject_doc(
            "bad_request",
            detail=f"op must be 'lu', 'hpd' or 'lstsq', got {op!r}")
    A = np.asarray(A)
    B = np.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    square_ok = A.ndim == 2 and A.shape[0] == A.shape[1]
    tall_ok = A.ndim == 2 and A.shape[0] >= A.shape[1]
    shape_ok = (tall_ok if op == "lstsq" else square_ok) \
        and B.ndim == 2 and B.shape[0] == A.shape[0]
    if not shape_ok:
        return reject_doc("bad_request",
                          detail=f"bad shapes A{A.shape} B{B.shape}")
    if not np.issubdtype(A.dtype, np.inexact):
        A = A.astype(np.float64)
        B = B.astype(np.float64)
    bucket = make_bucket(op, A.shape[1], B.shape[1], A.dtype,
                         m=A.shape[0] if op == "lstsq" else None)
    return op, A, B, bucket


class AdmissionController:
    """Buckets requests, estimates queue cost, sheds load.

    ``admit(op, A, B, deadline, queue_depth)`` validates the request,
    assigns its bucket, and EITHER returns a :class:`SolveRequest` or a
    ``serve_reject/v1`` dict when the estimated wait cannot fit the
    deadline (``shed=False`` disables shedding -- bench mode).  The
    caller owns the queue; ``queue_depth`` is the number of requests
    already waiting in the same bucket.  :attr:`backend` is the word of
    the device the batches run on (``'gpu'`` for a CUDA device, ``'cpu'``
    otherwise: the tuner's machine rows); it picks the default memory
    budget.  The owning service sets it from its grid; None means the
    default grid's device."""

    def __init__(self, *, shed: bool = True, max_batch: int = 8,
                 flops_per_s: float = COLD_FLOPS_PER_S,
                 clock=time.monotonic, hbm_bytes: float | None = None,
                 pipeline_depth: int = 2, grid: str | None = None):
        self.shed = bool(shed)
        self.max_batch = max(int(max_batch), 1)
        self.flops_per_s = float(flops_per_s)
        self.clock = clock
        #: per-device memory budget for the memory-pressure check.  None
        #: = the backend's row of the tuner's machine table, resolved on
        #: first use
        self.hbm_bytes = None if hbm_bytes is None else float(hbm_bytes)
        self.backend: str | None = None
        #: resident batches the worker keeps in flight: the
        #: memory-pressure threshold is ``depth x`` the single-batch
        #: peak -- 2 for the classic double buffer, k for a depth-k
        #: pipelined fleet member
        self.pipeline_depth = max(int(pipeline_depth), 1)
        #: fleet member name stamped into every reject this controller
        #: issues (None for a direct single-service deployment)
        self.grid = grid
        self._ids = itertools.count()
        self._ewma: dict = {}            # bucket.key() -> seconds per batch
        self._peak_memo: dict = {}       # bucket.key() -> peak bytes | None

    # ---- memory pressure ---------------------------------------------
    def _hbm_budget(self) -> float:
        if self.hbm_bytes is None:
            from ..tune.cost_model import machine_for
            backend = self.backend
            if backend is None:
                from ..core.grid import default_grid
                backend = "gpu" if default_grid().device.type == "cuda" \
                    else "cpu"
            self.hbm_bytes = float(machine_for(backend).hbm_bytes)
        return self.hbm_bytes

    def bucket_peak_bytes(self, bucket: Bucket) -> float | None:
        """Closed-form peak device bytes of ONE max_batch batch of this
        bucket (the executor's batched solve; no device execution).
        Memoized per bucket; None when the estimate is unavailable
        (never a reason to shed)."""
        key = bucket.key()
        if key in self._peak_memo:
            return self._peak_memo[key]
        try:                    # lazy: executor imports Bucket from here
            from .executor import batch_peak_bytes
            peak = batch_peak_bytes(bucket, self.max_batch)
        except Exception:
            peak = None
        self._peak_memo[key] = peak
        return peak

    def memory_pressure(self, bucket: Bucket):
        """(peak bytes, budget) when the bucket CANNOT fit, else None.

        The pipelined worker keeps ``pipeline_depth`` batches resident
        (in flight on device + staging), so the shed threshold is
        ``depth x`` the single batch peak against the per-device memory
        budget -- 2x for the classic double buffer.  A fleet member with
        a small per-grid budget therefore sheds a bucket its big-grid
        pool-mate still admits."""
        if not self.shed:
            return None
        peak = self.bucket_peak_bytes(bucket)
        if peak is None:
            return None
        budget = self._hbm_budget()
        if self.pipeline_depth * peak > budget:
            return peak, budget
        return None

    # ---- cost estimation --------------------------------------------
    def estimate_batch_s(self, bucket: Bucket) -> float:
        """Estimated seconds for ONE max_batch batch of this bucket:
        measured EWMA when warm, flops/throughput when cold."""
        est = self._ewma.get(bucket.key())
        if est is not None:
            return est
        return bucket.solve_flops() * self.max_batch / self.flops_per_s

    def observe_batch(self, bucket: Bucket, seconds: float) -> None:
        """Executor feedback: one batch of ``bucket`` took ``seconds``."""
        key = bucket.key()
        prev = self._ewma.get(key)
        s = float(seconds)
        self._ewma[key] = s if prev is None \
            else EWMA_ALPHA * s + (1.0 - EWMA_ALPHA) * prev

    def estimated_wait_s(self, bucket: Bucket, queue_depth: int) -> float:
        """Queue wait estimate: batches ahead x per-batch estimate (the
        request itself rides the LAST of those batches)."""
        batches = -(-max(int(queue_depth) + 1, 1) // self.max_batch)
        return batches * self.estimate_batch_s(bucket)

    # ---- admission ---------------------------------------------------
    def admit(self, op: str, A, B, deadline: Deadline | None = None,
              queue_depth=0, tenant: str | None = None, trace=None):
        """One admission decision: :class:`SolveRequest` or reject dict.

        ``queue_depth`` is the number of same-bucket requests already
        waiting -- an int, or a callable ``bucket -> int`` (the bucket is
        only known after validation, so a queue-owning caller passes its
        depth lookup).  ``tenant`` rides into the request and every
        reject this call issues (the fleet path).  ``trace`` is the
        request's lifecycle trace: admission marks the ``admitted`` edge
        (or closes it with ``shed``/``rejected``) and attaches it to the
        :class:`SolveRequest` so the executor can mark the batch
        stages."""
        v = validate_problem(op, A, B)
        if isinstance(v, dict):
            v["grid"] = self.grid
            v["tenant"] = tenant
            if trace is not None:
                trace.annotate(grid=self.grid, tenant=tenant)
                trace.mark("shed", reason=v["reason"])
                trace.mark("rejected")
                v["timeline"] = trace.to_doc()
            return v
        op, A, B, bucket = v
        if callable(queue_depth):
            queue_depth = int(queue_depth(bucket))
        pressure = self.memory_pressure(bucket)
        if pressure is not None:
            peak, budget = pressure
            return reject_doc(
                "memory_pressure", bucket=bucket, queue_depth=queue_depth,
                deadline=deadline, grid=self.grid, tenant=tenant,
                trace=trace,
                detail=f"static peak {int(peak)} B/batch x"
                       f"{self.pipeline_depth} ("
                       + ("double buffer"
                          if self.pipeline_depth == 2
                          else f"pipeline depth {self.pipeline_depth}")
                       + f") exceeds the {int(budget)} B HBM budget")
        if deadline is not None:
            if deadline.expired():
                return reject_doc("deadline_expired", bucket=bucket,
                                  queue_depth=queue_depth, deadline=deadline,
                                  grid=self.grid, tenant=tenant, trace=trace)
            if self.shed:
                wait = self.estimated_wait_s(bucket, queue_depth)
                if wait > deadline.remaining():
                    return reject_doc(
                        "queue_pressure", bucket=bucket,
                        queue_depth=queue_depth, estimate_s=wait,
                        deadline=deadline, grid=self.grid, tenant=tenant,
                        trace=trace,
                        detail=f"estimated wait {wait:.3g}s exceeds "
                               f"remaining {deadline.remaining():.3g}s")
        req = SolveRequest(id=next(self._ids), op=op, A=A, B=B,
                           bucket=bucket, deadline=deadline,
                           submitted=self.clock(), tenant=tenant,
                           trace=trace)
        if trace is not None:
            trace.annotate(id=trace.id if trace.id is not None else req.id,
                           grid=self.grid, tenant=tenant, bucket=bucket,
                           op=op)
            trace.mark("admitted", grid=self.grid, bucket=bucket.key(),
                       queue_depth=queue_depth)
        return req
