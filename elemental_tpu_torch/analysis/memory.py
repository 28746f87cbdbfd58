"""Memory plans (``memory_plan/v1``) from a measured run.

The twin of the JAX package's ``analysis/memory.py``.  The JAX package
walks a jaxpr for liveness; the port has no jaxpr, so it MEASURES: the
driver runs once to warm every cache, then once more under
``torch.profiler.profile(profile_memory=True)``, whose allocator events
(every allocation and free of the grid's device, with its bytes) give
the live total above the inputs at every moment of the call.  The same
meter works on the CPU and on CUDA; on the card its peak equals
``torch.cuda.max_memory_allocated()`` above the warm baseline.

The per-device model is the JAX package's.  The virtual grid keeps one
stacked-storage copy of every matrix, so the meter's total divided by
``p`` is the evenly-sharded residency of one device; the replicated
forms a real grid keeps more copies of are priced by the census of the
engine's redistribution log (:func:`replication_census`, a copy of the
JAX function), and

    peak_bytes = ceil(meter peak / p) + the largest replicated extra.

``args_bytes`` / ``outs_bytes`` are the JAX closed forms: the inputs'
and outputs' storage bytes, ``ceil(bytes / p)`` each.  Every measured
allocation ran, so ``static`` is true and ``nonstatic_peak_bytes`` 0.
``peak_path`` names the driver and the phase the peak fell in (the
``obs`` phase names of the drivers' ticks, ``phase[step]``), and
``peak_prim`` the aten op that allocated it; the timeline keeps the last
high-water marks in that form.

Lint EL007 is the port's shared-memory check: ``lu_panel`` keeps each
thread block's slab of rows in shared memory while
``ceil((M - s) / G) * SROW * sizeof(T)`` fits beside the column kernel's
static shared memory (``csrc/lu_panel.cu``), and past that works the
panel in place in device memory.  :func:`kernel_smem_bytes` is that
closed form, on the card's constants (:data:`SMEM_ROWS`).
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import json
import math

import numpy as np
import torch

from ..core.dist import stride as dist_stride
from ..core.distmatrix import DistMatrix

MEM_SCHEMA = "memory_plan/v1"

#: high-water marks kept in the timeline (the last, i.e. highest, ones)
TIMELINE_CAP = 8


# ---------------------------------------------------------------------
# the live-bytes meter
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HighWater:
    """One new peak of the meter (per-device bytes)."""
    live_bytes: int
    path: tuple                  # (driver, phase[step])
    prim: str                    # the aten op that allocated

    def to_doc(self) -> dict:
        return {"live_bytes": self.live_bytes, "path": "/".join(self.path),
                "prim": self.prim}


@dataclasses.dataclass
class MeterStats:
    """One measured call, per device (the twin of the JAX ``WalkStats``)."""
    peak_bytes: int              # args + ceil(peak above the inputs / p)
    peak_path: tuple
    peak_prim: str
    args_bytes: int              # per-device input residency
    outs_bytes: int              # per-device output residency
    timeline: list               # list[HighWater], the last TIMELINE_CAP
    #: the meter's raw peak: bytes allocated above the inputs, whole grid
    total_peak_bytes: int = 0
    nonstatic_peak_bytes: int = 0
    in_sigs: tuple = ()          # ((shape, dtype), ...) of the inputs
    out_sigs: tuple = ()         # ... of the outputs

    @property
    def static(self) -> bool:
        return self.nonstatic_peak_bytes == 0


def _leaves(obj) -> list:
    """The tensors of a driver's inputs or result: a DistMatrix's storage,
    a tensor, or those inside tuples / lists."""
    if isinstance(obj, DistMatrix):
        return [obj.local]
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in _leaves(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _per_device(tensors, p: int) -> int:
    return sum(-(-_nbytes(t) // p) for t in tensors)


def _sig(t: torch.Tensor) -> tuple:
    return tuple(t.shape), str(t.dtype).removeprefix("torch.")


class _Segments:
    """A driver's phase hook (``start()`` / ``tick(phase, step)``) that
    opens a profiler range per phase: the range between two ticks is
    named by the later tick, the one after the last tick ``'return'``."""

    def __init__(self):
        self.labels: list = []
        self._rf = None

    def _open(self):
        self._rf = torch.autograd.profiler.record_function(
            f"el.seg#{len(self.labels)}")
        self._rf.__enter__()

    def _close(self):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None

    def start(self):
        if self._rf is None:
            self._open()

    def tick(self, phase, step, *arrays):
        self._close()
        self.labels.append(f"{phase}[{int(step)}]")
        self._open()


def _profile_call(fn, args, device_type: str, timed: bool):
    """Run ``fn(*args)`` under the profiler's memory events; return
    ``(result, marks, total_peak)``: ``marks`` the new-peak events as
    ``(live bytes above the inputs, segment label, aten op)``."""
    seg = _Segments() if timed else None
    kw = {"timer": seg} if timed else {}
    acts = [torch.profiler.ProfilerActivity.CPU]
    want = torch.autograd.DeviceType.CUDA if device_type == "cuda" \
        else torch.autograd.DeviceType.CPU
    enabled = gc.isenabled()
    gc.disable()            # no cycle collection inside the measured call
    try:
        with torch.profiler.profile(activities=acts,
                                    profile_memory=True) as prof:
            out = fn(*args, **kw)
            if seg is not None:
                seg._close()
            if device_type == "cuda":
                torch.cuda.synchronize()
    finally:
        if enabled:
            gc.enable()
    evs = list(prof.profiler.kineto_results.events())
    mem, ops, segs = [], [], []
    for e in evs:
        name = e.name()
        if name == "[memory]":
            if e.device_type() == want:
                mem.append((e.start_ns(), e.nbytes()))
        elif name.startswith("el.seg#"):
            segs.append((e.start_ns(), int(name[7:])))
        elif name.startswith("aten::"):
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    mem.sort(key=lambda m: m[0])
    ops.sort(key=lambda o: (o[0], -o[1]))
    segs.sort()
    seg_t = [s[0] for s in segs]
    labels = seg.labels if seg is not None else []
    marks, run, peak = [], 0, 0
    stack, oi = [], 0
    for ts, nbytes in mem:
        while oi < len(ops) and ops[oi][0] <= ts:
            while stack and stack[-1][1] < ops[oi][0]:
                stack.pop()
            stack.append(ops[oi])
            oi += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        run += nbytes
        if run > peak:
            peak = run
            k = bisect.bisect_right(seg_t, ts) - 1
            idx = segs[k][1] if k >= 0 else 0
            label = labels[idx] if idx < len(labels) else (
                "return" if labels else "")
            marks.append((run, label, stack[-1][2] if stack else ""))
    return out, marks, peak


def measure_call(fn, args, grid_shape, name: str = "custom",
                 timed: bool = False, device_type: str = "cpu"):
    """Measure one call of ``fn(*args)`` on a virtual grid of
    ``grid_shape``; return ``(MeterStats, result)``.  ``timed`` passes a
    phase hook as ``timer=`` (the drivers that tick)."""
    p = max(int(grid_shape[0]) * int(grid_shape[1]), 1)
    ins = _leaves(list(args))
    args_bytes = _per_device(ins, p)
    out, marks, total = _profile_call(fn, args, device_type, timed)
    outs = _leaves(out)
    timeline = [HighWater(args_bytes + -(-b // p),
                          (name,) + ((label,) if label else ()), prim)
                for b, label, prim in marks][-TIMELINE_CAP:]
    last = timeline[-1] if timeline else HighWater(args_bytes, (name,), "")
    stats = MeterStats(peak_bytes=args_bytes + -(-total // p),
                       peak_path=last.path, peak_prim=last.prim,
                       args_bytes=args_bytes,
                       outs_bytes=_per_device(outs, p), timeline=timeline,
                       total_peak_bytes=total,
                       in_sigs=tuple(_sig(t) for t in ins),
                       out_sigs=tuple(_sig(t) for t in outs))
    return stats, out


# ---------------------------------------------------------------------
# replicated-materialization census (a copy of the JAX function)
# ---------------------------------------------------------------------

def _replication(dst, grid_shape) -> int:
    """Copies of the operand per ``p`` devices in the ``dst`` form (1 for
    evenly sharded pairs, ``c`` for [MC,STAR], ``p`` for [STAR,STAR];
    [CIRC,CIRC] prices like [STAR,STAR])."""
    r, c = int(grid_shape[0]), int(grid_shape[1])
    p = max(r * c, 1)
    cover = min(dist_stride(dst[0], r, c) * dist_stride(dst[1], r, c), p)
    return max(1, p // max(cover, 1))


def replication_census(redist_log, grid_shape) -> dict:
    """The replicated section of a ``memory_plan/v1`` document from the
    engine's redistribution log: per destination form, the per-device
    bytes it keeps above the evenly-sharded model
    (``total * (repl - 1) / p``)."""
    r, c = int(grid_shape[0]), int(grid_shape[1])
    agg: dict = {}
    star_star = 0
    max_extra = 0
    sum_extra = 0
    for rec in redist_log:
        gs = tuple(rec.grid_shape or (r, c))
        dst_pairs = rec.dst if rec.kind == "panel_spread" else (rec.dst,)
        try:
            z = np.dtype(rec.dtype).itemsize
        except TypeError:
            z = getattr(torch, rec.dtype).itemsize
        total = int(rec.gshape[0]) * int(rec.gshape[1]) * z
        rec_extra = 0
        for dst in dst_pairs:
            repl = _replication(dst, gs)
            if repl <= 1:
                continue
            names = tuple(d.value for d in dst)
            extra = total * (repl - 1) // max(gs[0] * gs[1], 1)
            if names == ("STAR", "STAR"):
                star_star += 1
            rec_extra += extra
            sum_extra += extra
            key = (f"[{names[0]},{names[1]}]",
                   tuple(int(x) for x in rec.gshape), str(rec.dtype))
            site = agg.setdefault(key, {"count": 0, "extra_bytes": 0})
            site["count"] += 1
            site["extra_bytes"] += extra
        max_extra = max(max_extra, rec_extra)
    sites = [{"dst": dst, "gshape": list(gshape), "dtype": dt,
              "count": s["count"], "extra_bytes": s["extra_bytes"]}
             for (dst, gshape, dt), s in sorted(agg.items(),
                                                key=lambda kv: repr(kv[0]))]
    return {"count": sum(s["count"] for s in sites),
            "star_star": star_star, "max_extra_bytes": max_extra,
            "sum_extra_bytes": sum_extra, "sites": sites}


# ---------------------------------------------------------------------
# the memory plan document
# ---------------------------------------------------------------------

@dataclasses.dataclass
class MemoryPlan:
    """The measured memory profile of one driver call."""
    driver: str
    grid: tuple                  # (r, c)
    meta: dict                   # the comm plan's meta
    stats: MeterStats
    replicated: dict             # replication_census() output

    @property
    def peak_bytes(self) -> int:
        """The meter's per-device peak + the largest replicated extra."""
        return self.stats.peak_bytes + int(
            self.replicated.get("max_extra_bytes", 0))

    @property
    def static(self) -> bool:
        return self.stats.static

    def to_doc(self) -> dict:
        doc = {"schema": MEM_SCHEMA, "driver": self.driver,
               "grid": list(self.grid)}
        doc.update(self.meta)
        doc["static"] = self.static
        doc["peak_bytes"] = self.peak_bytes
        doc["walk_peak_bytes"] = self.stats.peak_bytes
        doc["peak_path"] = "/".join(self.stats.peak_path)
        doc["peak_prim"] = self.stats.peak_prim
        doc["args_bytes"] = self.stats.args_bytes
        doc["outs_bytes"] = self.stats.outs_bytes
        doc["nonstatic_peak_bytes"] = self.stats.nonstatic_peak_bytes
        doc["replicated"] = dict(self.replicated)
        doc["timeline"] = [hw.to_doc() for hw in self.stats.timeline]
        return doc

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_doc(), indent=indent, sort_keys=False)


def memory_plan(driver: str, grid, meta: dict, stats: MeterStats,
                redist_log=()) -> MemoryPlan:
    """Assemble a :class:`MemoryPlan` from one measured call."""
    grid = tuple(int(g) for g in grid)
    return MemoryPlan(driver=driver, grid=grid, meta=dict(meta),
                      stats=stats,
                      replicated=replication_census(redist_log, grid))


def trace_memory(name: str, grid, n=None, nb=None, dtype=None):
    """Run a registered driver twice on ``grid`` (a warm-up, then the
    measured call) and return ``(MemoryPlan, records, notes)`` -- the
    memory twin of :func:`.drivers.trace_driver`.  The records hold no
    tensor alive (their ``in_id`` s may repeat); lint the comm trace's
    records where identity matters."""
    from ..redist import engine as _engine
    from .drivers import DEFAULT_N, DEFAULT_NB, DRIVERS, build_driver
    fn, args, meta = build_driver(
        name, grid, DEFAULT_N if n is None else n,
        DEFAULT_NB if nb is None else nb,
        np.float32 if dtype is None else dtype)
    timed = DRIVERS[name].timed
    with _engine.isolated_probe(refs=False):
        fn(*args)                                      # warm every cache
    with _engine.isolated_probe(refs=False) as (records, notes):
        stats, _ = measure_call(fn, args, (grid.height, grid.width), name,
                                timed, grid.device.type)
    mplan = memory_plan(name, (grid.height, grid.width), meta, stats,
                        records)
    return mplan, list(records), list(notes)


def golden_mem_doc(mplan: MemoryPlan) -> dict:
    """The snapshot form (the whole document)."""
    return mplan.to_doc()


#: the keys of a memory_plan/v1 document that the port measures (the JAX
#: package walks them): compared only between two port documents
MEASURED_KEYS = ("peak_bytes", "walk_peak_bytes", "peak_path", "peak_prim",
                 "timeline")


def diff_mem_docs(golden: dict, current: dict,
                  measured: bool = True) -> list:
    """Human-readable mismatch lines between two memory_plan/v1 docs.
    ``measured=False`` skips :data:`MEASURED_KEYS` (a port document held
    to a JAX golden)."""
    lines: list = []
    scalar_keys = ("schema", "driver", "grid", "n", "nb", "dtype", "static",
                   "peak_bytes", "walk_peak_bytes", "peak_path", "peak_prim",
                   "args_bytes", "outs_bytes", "nonstatic_peak_bytes")
    if not measured:
        scalar_keys = tuple(k for k in scalar_keys if k not in MEASURED_KEYS)
    for key in scalar_keys:
        if golden.get(key) != current.get(key):
            lines.append(f"{key}: golden={golden.get(key)!r} "
                         f"current={current.get(key)!r}")
    gr = golden.get("replicated", {})
    cr = current.get("replicated", {})
    for key in ("count", "star_star", "max_extra_bytes", "sum_extra_bytes"):
        if gr.get(key) != cr.get(key):
            lines.append(f"replicated[{key}]: golden={gr.get(key)} "
                         f"current={cr.get(key)}")

    def _rows(doc_rep):
        return set(json.dumps(s, sort_keys=True, default=str)
                   for s in doc_rep.get("sites", []))

    gs, cs = _rows(gr), _rows(cr)
    for row in sorted(gs - cs):
        lines.append(f"replicated site missing vs golden: {row}")
    for row in sorted(cs - gs):
        lines.append(f"replicated site not in golden: {row}")
    gt = golden.get("timeline", [])
    ct = current.get("timeline", [])
    if measured and gt != ct:
        lines.append(f"timeline: golden={len(gt)} mark(s) "
                     f"{json.dumps(gt[-1] if gt else None, default=str)} "
                     f"current={len(ct)} mark(s) "
                     f"{json.dumps(ct[-1] if ct else None, default=str)}")
    return lines


# ---------------------------------------------------------------------
# lu_panel's shared-memory slab (lint EL007 support)
# ---------------------------------------------------------------------

#: ``csrc/lu_panel.cu``: a slab row's stride (CW + 1) and the fewest rows
#: worth a thread block
SROW = 65
ROWS_PER_CTA = 64


@dataclasses.dataclass(frozen=True)
class SmemRow:
    """A card's numbers behind the slab test: SMs (the cap on a launch's
    thread blocks), opt-in shared memory per block, and the column
    kernel's static shared memory per dtype."""
    name: str
    sm_count: int
    smem_optin: int
    static_smem: dict            # dtype name -> bytes

    def dyn_max(self, dtype) -> int:
        return self.smem_optin - self.static_smem[np.dtype(dtype).name]


#: read on an NVIDIA H100 80GB HBM3 (``kernels.lu_panel.smem_constants``
#: and ``torch.cuda.get_device_properties``; chip_smoke phase 3o checks
#: them on every run)
SMEM_ROWS = {
    "gpu": SmemRow(name="NVIDIA H100 80GB HBM3", sm_count=132,
                   smem_optin=232448,
                   static_smem={"float32": 1600, "float64": 1920}),
}


@dataclasses.dataclass(frozen=True)
class PanelSmemCheck:
    """The slab test of one ``lu_panel`` dispatch on one card."""
    op: str
    shape: tuple
    dtype: str
    slab_bytes: int              # the largest slab (the first column's)
    budget: int                  # dynamic shared memory the slab may take
    fits: bool

    @property
    def spills(self) -> bool:
        """True when the panel is worked in device memory."""
        return not self.fits

    def to_doc(self) -> dict:
        return {"op": self.op, "shape": list(self.shape),
                "dtype": self.dtype, "slab_bytes": self.slab_bytes,
                "budget": self.budget, "fits": self.fits}


def kernel_smem_bytes(op: str, shape, dtype, row: SmemRow = None) -> int:
    """Bytes of ``lu_panel``'s slab for an (M, nbw) panel at its first
    column: ``ceil(M / G) * SROW * sizeof(T)`` with ``G = min(ceil(M /
    ROWS_PER_CTA), SMs)`` thread blocks (later columns take fewer rows)."""
    if op != "lu":
        raise KeyError(f"no shared-memory slab for op {op!r}")
    row = SMEM_ROWS["gpu"] if row is None else row
    M = int(shape[0])
    G = min(math.ceil(M / ROWS_PER_CTA), row.sm_count)
    return math.ceil(M / max(G, 1)) * SROW * np.dtype(dtype).itemsize


def check_panel_smem(op: str, shape, dtype="float32",
                     row: SmemRow = None) -> PanelSmemCheck:
    """The slab test of one panel shape on ``row``'s card."""
    row = SMEM_ROWS["gpu"] if row is None else row
    slab = kernel_smem_bytes(op, shape, dtype, row)
    budget = row.dyn_max(dtype)
    return PanelSmemCheck(op=op, shape=tuple(int(s) for s in shape),
                          dtype=np.dtype(dtype).name, slab_bytes=slab,
                          budget=budget, fits=slab <= budget)


def spill_rows(dtype="float32", row: SmemRow = None) -> int:
    """The tallest panel whose slab stays in shared memory on ``row``."""
    row = SMEM_ROWS["gpu"] if row is None else row
    per_block = row.dyn_max(dtype) // (SROW * np.dtype(dtype).itemsize)
    return per_block * row.sm_count


def panel_shapes(op: str, n: int, nb: int) -> list:
    """The panel shapes a blocked sweep of ``op`` at (n, nb) dispatches:
    (remaining rows, block) for lu / qr, the (w, w) diagonal blocks for
    cholesky."""
    shapes = []
    for k in range(0, max(int(n), 1), max(int(nb), 1)):
        w = min(int(nb), int(n) - k)
        if w <= 0:
            break
        shapes.append((w, w) if op == "cholesky" else (int(n) - k, w))
    return shapes


def panel_smem_checks(op: str, n: int, nb: int, dtype="float32",
                      row: SmemRow = None) -> list:
    """The slab test of every ``lu_panel`` dispatch of one blocked sweep
    (none for an op without a slab)."""
    if op != "lu":
        return []
    return [check_panel_smem(op, s, dtype, row)
            for s in panel_shapes(op, n, nb)]
