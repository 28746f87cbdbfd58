"""Runtime span tracer: nested spans, driver phase hooks, collective events.

PyTorch port of ``elemental_tpu/obs/tracer.py``.  A :class:`Tracer`
records three kinds of evidence from ONE run:

  * explicit spans -- ``with tracer.span(name, sync=outputs, **attrs):``
    blocks that nest via a per-thread stack; ``sync`` takes the phase's
    output tensors and the span closes only after their device has
    finished (:func:`block_until_ready`), so the recorded wall-clock is
    honest under CUDA's asynchronous launches;
  * phase records -- the driver hooks.  Every tuned driver (``cholesky``,
    ``lu``, ``qr``, ``gemm``, ``trsm``, ``herk``) calls the PhaseTimer
    tick protocol (``start()`` + ``tick(phase, step, *tensors)``) at its
    phase boundaries; a tracer-backed :class:`_TickChannel` turns those
    ticks into (driver, phase, step, t0, t1) records, from which the
    exporter synthesizes the driver -> step -> phase span nesting;
  * collective events -- while a tracer is ACTIVE (``with tracer:``), it
    observes the redistribution engine (``add_redist_observer``), so every
    public ``redistribute`` / ``panel_spread`` entry lands as an instant
    event carrying src/dst distributions, global shape, dtype and a
    ring-model byte estimate, attributed to the innermost open span / most
    recent driver.

Activation also makes the tracer the process-current one, so
:func:`phase_hook` -- the line each driver runs at entry -- routes the
driver's ticks here without any driver-level plumbing.

Where the JAX package calls ``jax.block_until_ready``, the port waits for
the device of the tensors it is given: a tick on a CUDA tensor costs one
``torch.cuda.synchronize(device)`` (the host loses its run-ahead at every
phase boundary), a tick on CPU tensors costs nothing.  While the current
stream is capturing a CUDA graph no sync is issued (a sync would abort
the capture), as JAX's tick does nothing under ``jit``.

Threads: the JAX tracer keys a record's thread by
``threading.get_ident()``, which Python hands again to a thread started
after an earlier one was joined, so two serial workers could share one
exporter track.  The port records a per-thread TOKEN instead: the tracer
hands each recording thread the next integer the first time it records
(thread-local, so a later thread never inherits it); the tracer's
constructing thread holds token 1, its home thread.

Metrics: unless constructed with ``metrics=False``, every phase record
feeds a ``phase_seconds{driver,phase}`` histogram and every collective
event bumps ``redist_calls{label}`` / ``redist_bytes{label}`` /
``redist_wire_bytes{label}`` counters on the CURRENT :mod:`.metrics`
registry; :func:`phase_hook` additionally counts ``op_calls{op}`` per
driver entry.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from . import metrics as _metrics

TRACE_SCHEMA = "obs_trace/v1"


@dataclasses.dataclass
class Span:
    """One explicit (context-manager) span."""
    name: str
    t0: float
    t1: float | None
    depth: int
    attrs: dict
    #: originating thread's token (0 = unattributed); the exporter keys
    #: Chrome-trace tracks by it
    thread: int = 0
    thread_name: str = ""


@dataclasses.dataclass
class PhaseRecord:
    """One driver phase interval reconstructed from a tick."""
    driver: str
    phase: str
    step: int
    t0: float
    t1: float
    call: int                    # driver-invocation ordinal (channel id)
    thread: int = 0
    thread_name: str = ""

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class InstantEvent:
    """One generic instant event (e.g. a resilience health flag)."""
    t: float
    name: str
    attrs: dict
    thread: int = 0
    thread_name: str = ""


@dataclasses.dataclass
class CommEvent:
    """One public redistribute/panel_spread entry observed at runtime."""
    t: float
    kind: str                    # "redistribute" | "panel_spread" | "row_permute"
    label: str                   # "[MC,MR]->[STAR,STAR]" | "panel_spread"
    gshape: tuple
    dtype: str
    bytes: int                   # ring-model estimate at the LOGICAL dtype
    span: str | None             # innermost open explicit span
    driver: str | None           # most recent driver channel
    #: dtype/bytes actually on the wire (== dtype/bytes unless the entry
    #: ran under a ``comm_precision`` mode)
    wire_dtype: str = ""
    wire_bytes: int = 0
    #: route the engine resolved: "chain" | "direct" | "storage"
    path: str = ""
    #: collective rounds of the resolved route (-1 = engine didn't price)
    rounds: int = -1
    #: the engine's ring-model pricing of the resolved route at the wire
    #: dtype (-1 = not computed)
    engine_wire_bytes: int = -1
    thread: int = 0
    thread_name: str = ""


def _itemsize(dtype) -> int:
    """Bytes per element of a dtype given as a name, numpy dtype or torch
    dtype; 4 when it names none ("bfloat16" is 2, as with the JAX
    package's ml_dtypes)."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    try:
        return np.dtype(dtype).itemsize
    except TypeError:
        tdt = getattr(torch, str(dtype), None)
        return tdt.itemsize if isinstance(tdt, torch.dtype) else 4


def ring_bytes(gshape, dtype, grid_shape) -> int:
    """Ring-model per-device byte estimate for moving a ``gshape`` matrix
    across a ``grid_shape`` grid: each rank receives the payload minus its
    own shard, ``payload * (p - 1) / p`` (0 on a 1x1 grid -- no collective
    executes)."""
    payload = _itemsize(dtype)
    for d in gshape:
        payload *= int(d)
    p = 1
    for d in grid_shape:
        p *= int(d)
    if p <= 1:
        return 0
    return payload * (p - 1) // p


def _tensors(tree):
    """The tensors of a tree of tuples / lists / dicts / DistMatrix-like
    objects (anything with a ``.local``) and device-grid Tiles."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)
    elif hasattr(tree, "local"):
        yield from _tensors(tree.local)
    elif hasattr(tree, "tiles"):           # a device grid's Tiles
        yield from tree.tiles


def block_until_ready(tree) -> None:
    """Wait until the device work producing ``tree``'s tensors is done.

    One ``torch.cuda.synchronize`` per CUDA device among the tensors;
    nothing for CPU tensors (their values exist when the call returns),
    and nothing while the current stream captures a CUDA graph."""
    devices = {t.device for t in _tensors(tree) if t.is_cuda}
    if not devices or torch.cuda.is_current_stream_capturing():
        return
    for dev in devices:
        torch.cuda.synchronize(dev)


class NullHook:
    """Zero-overhead stand-in so drivers can call tick() unconditionally."""
    __slots__ = ()

    def start(self):
        pass

    def tick(self, phase, step, *arrays):
        pass


NULL_HOOK = NullHook()


class _TickChannel:
    """One driver invocation's tick stream (PhaseTimer protocol)."""
    __slots__ = ("tracer", "driver", "attrs", "call", "_t")

    def __init__(self, tracer: "Tracer", driver: str, call: int, attrs: dict):
        self.tracer = tracer
        self.driver = driver
        self.attrs = attrs
        self.call = call
        self._t = None

    def start(self):
        """(Re)arm the clock at a driver's entry."""
        self._t = self.tracer.clock()

    def tick(self, phase, step, *arrays):
        """Wait for ``arrays`` and close the [previous-tick, now] phase."""
        if arrays:
            block_until_ready(arrays)
        now = self.tracer.clock()
        t0 = self._t if self._t is not None else now
        self.tracer._add_phase(self.driver, str(phase), int(step), t0, now,
                               self.call)
        self._t = now


class _Fanout:
    """Tick fan-out: an explicit PhaseTimer AND the active tracer both see
    every tick (the first hook's sync makes the second ~free)."""
    __slots__ = ("hooks",)

    def __init__(self, hooks):
        self.hooks = tuple(hooks)

    def start(self):
        for h in self.hooks:
            h.start()

    def tick(self, phase, step, *arrays):
        for h in self.hooks:
            h.tick(phase, step, *arrays)


_ACTIVE: "Tracer | None" = None


def active_tracer() -> "Tracer | None":
    """The tracer currently activated via ``with tracer:``, if any."""
    return _ACTIVE


class Tracer:
    """Collects spans, driver phase records, and collective events.

    Thread-safe: the shared record lists append under one lock; span
    NESTING state (the open-span stack and the most-recent-driver
    attribution) and the thread token are thread-local, so each thread
    nests independently and the exporter keys tracks by the token.
    """

    def __init__(self, metrics: bool = True, clock=time.perf_counter):
        self.clock = clock
        self.spans: list[Span] = []
        self.phases: list[PhaseRecord] = []
        self.comms: list[CommEvent] = []
        self.instants: list[InstantEvent] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ntokens = 0
        self._metrics = metrics
        self._ncalls = 0
        self._prev_active: Tracer | None = None
        self._unobserve = None
        self.home_thread = self._whoami()[0]

    def _thread_stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @property
    def _cur_driver(self):
        return getattr(self._tls, "driver", None)

    @_cur_driver.setter
    def _cur_driver(self, driver):
        self._tls.driver = driver

    def _whoami(self) -> tuple:
        """(this thread's token, its name); the token is handed out the
        first time a thread records and dies with the thread."""
        tok = getattr(self._tls, "token", None)
        if tok is None:
            with self._lock:
                self._ntokens += 1
                tok = self._tls.token = self._ntokens
        return tok, threading.current_thread().name

    # ---- explicit spans ---------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, sync=None, **attrs):
        """Open a nested span; if ``sync`` is given (tensors / a tree of
        them), the span waits for their device before closing so the
        duration is honest."""
        stack = self._thread_stack()
        tok, tname = self._whoami()
        s = Span(name=str(name), t0=self.clock(), t1=None,
                 depth=len(stack), attrs=dict(attrs), thread=tok,
                 thread_name=tname)
        with self._lock:
            self.spans.append(s)
        stack.append(s)
        try:
            yield s
        finally:
            if sync is not None:
                block_until_ready(sync)
            s.t1 = self.clock()
            stack.pop()

    # ---- driver tick channels ---------------------------------------
    def channel(self, driver: str, **attrs) -> _TickChannel:
        """A fresh tick channel; one per driver invocation."""
        with self._lock:
            self._ncalls += 1
            call = self._ncalls
        self._cur_driver = driver
        return _TickChannel(self, driver, call, attrs)

    def _add_phase(self, driver, phase, step, t0, t1, call):
        tok, tname = self._whoami()
        rec = PhaseRecord(driver, phase, step, t0, t1, call,
                          thread=tok, thread_name=tname)
        with self._lock:
            self.phases.append(rec)
        self._cur_driver = driver
        if self._metrics:
            _metrics.observe("phase_seconds", t1 - t0, driver=driver,
                             phase=phase)

    # ---- generic instant events -------------------------------------
    def instant(self, name: str, **attrs) -> None:
        """Record a zero-duration event (rendered on an ``events`` track
        by the Chrome-trace exporter): the health guards' ``health:<kind>``
        flags, and request lifecycle marks with a ``flow=`` attr, which
        the exporter links into flow events (``ph: s/t/f``)."""
        tok, tname = self._whoami()
        ev = InstantEvent(t=self.clock(), name=str(name),
                          attrs=dict(attrs), thread=tok, thread_name=tname)
        with self._lock:
            self.instants.append(ev)

    # ---- engine observer --------------------------------------------
    def _on_redist(self, rec) -> None:
        grid_shape = getattr(rec, "grid_shape", ())
        nbytes = ring_bytes(rec.gshape, rec.dtype, grid_shape)
        wire = getattr(rec, "wire_dtype", "") or rec.dtype
        wbytes = nbytes if wire == rec.dtype \
            else ring_bytes(rec.gshape, wire, grid_shape)
        stack = self._thread_stack()
        tok, tname = self._whoami()
        ev = CommEvent(
            t=self.clock(), kind=rec.kind, label=rec.label,
            gshape=tuple(rec.gshape), dtype=rec.dtype, bytes=nbytes,
            span=stack[-1].name if stack else None,
            driver=self._cur_driver, wire_dtype=wire, wire_bytes=wbytes,
            path=str(getattr(rec, "path", "") or ""),
            rounds=int(getattr(rec, "rounds", -1)),
            engine_wire_bytes=int(getattr(rec, "wire_bytes", -1)),
            thread=tok, thread_name=tname)
        with self._lock:
            self.comms.append(ev)
        if self._metrics:
            _metrics.inc("redist_calls", label=rec.label)
            _metrics.inc("redist_bytes", nbytes, label=rec.label)
            _metrics.inc("redist_wire_bytes", wbytes, label=rec.label)
            _metrics.observe("redist_event_bytes", wbytes,
                             label=rec.label)

    # ---- activation --------------------------------------------------
    def __enter__(self) -> "Tracer":
        global _ACTIVE
        from ..redist.engine import add_redist_observer
        self._prev_active = _ACTIVE
        _ACTIVE = self
        self._unobserve = add_redist_observer(self._on_redist)
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = self._prev_active
        self._prev_active = None
        if self._unobserve is not None:
            self._unobserve()
            self._unobserve = None

    # ---- aggregation -------------------------------------------------
    def redist_counts(self) -> dict:
        """{label: count} over the recorded collective events, the
        storage-level ``row_permute`` entries excluded (the runtime twin
        of a ``comm_plan/v1`` document's ``redistributes`` table)."""
        out: dict = {}
        for ev in self.comms:
            if ev.kind == "row_permute":
                continue
            out[ev.label] = out.get(ev.label, 0) + 1
        return dict(sorted(out.items()))

    def redist_bytes_total(self) -> int:
        return sum(ev.bytes for ev in self.comms)

    def redist_wire_bytes_total(self) -> int:
        """Total estimated bytes on the wire -- equals
        :meth:`redist_bytes_total` unless some entries ran under a
        ``comm_precision`` mode."""
        return sum(ev.wire_bytes for ev in self.comms)

    def phase_totals(self) -> dict:
        """{driver: {phase: seconds}} aggregated over all records."""
        out: dict = {}
        for r in self.phases:
            d = out.setdefault(r.driver, {})
            d[r.phase] = d.get(r.phase, 0.0) + r.seconds
        return out

    def driver_calls(self) -> list:
        """[(call id, driver, t0, t1, steps)] synthesized from phase
        records -- one entry per driver invocation (tick channel)."""
        return _driver_calls(self.phases)


def _driver_calls(phases) -> list:
    """[(call, driver, t0, t1, steps)] synthesized from ``phases``."""
    agg: dict = {}
    for r in phases:
        cur = agg.get(r.call)
        if cur is None:
            agg[r.call] = [r.call, r.driver, r.t0, r.t1, {r.step}]
        else:
            cur[2] = min(cur[2], r.t0)
            cur[3] = max(cur[3], r.t1)
            cur[4].add(r.step)
    return [tuple(v[:4]) + (sorted(v[4]),) for _, v in sorted(agg.items())]


def phase_hook(driver: str, timer=None, **attrs):
    """The one-line driver integration: resolve this invocation's tick
    hook.  Counts the invocation (``op_calls{op=driver}`` on the current
    metrics registry), then returns

      * the explicit ``timer`` when no tracer is active,
      * the active tracer's fresh channel when one is activated,
      * a fan-out over both when both are present,
      * the shared :data:`NULL_HOOK` when neither.
    """
    _metrics.inc("op_calls", op=driver)
    tr = _ACTIVE
    if tr is None:
        return timer if timer is not None else NULL_HOOK
    chan = tr.channel(driver, **attrs)
    chan.start()
    if timer is None:
        return chan
    return _Fanout((timer, chan))
