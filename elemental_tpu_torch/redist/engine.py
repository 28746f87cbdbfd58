"""The redistribution engine.

PyTorch port of ``elemental_tpu/redist/engine.py`` (the reference's
``El::copy`` namespace, Elemental ``src/blas_like/level1/Copy/*.hpp``).
On a device grid (every rank's block on its own device) a
redistribution runs the JAX engine's collective route, hop for hop
(:mod:`.device_route`).  On a virtual grid every rank's block lives in
one stacked-storage tensor on one device, and stacked storage is a pure
index permutation of the global matrix.  So there the default route of
every pair goes through the global matrix,

    B = from_global(to_global(A), cdist, rdist, calign, ralign),

which moves values and does no arithmetic: the result is bit-identical to
the JAX engine's storage.  On a 1x1 grid every distribution's storage IS
the global matrix, so there a redistribution only retags (a fresh view
of the same storage).

What the engine records is what a real r x c grid moves, the same on
both kinds of grid: every
public :func:`redistribute` / :func:`panel_spread` entry is counted
(:data:`REDIST_COUNTS`, :func:`redist_counts`) and described by a
:class:`RedistRecord` (:func:`redist_trace`, :func:`add_redist_observer`)
whose ``rounds`` and ``wire_bytes`` come from the chain metadata of the
JAX engine's factored collective hops (:func:`chain_cost`) or from the
compiled one-shot plan (:mod:`.plan`).  On the virtual grid the chain's
hops are not run one by one: the data moves through the one composed
index map above.

``path='direct'`` carries out the compiled plan's own gather/scatter
index maps on the stacked storage, which tests the plan compiler rather
than bypassing it.  ``comm_precision`` (``'bf16'`` / ``'int8'``, the
codec of :mod:`.quantize`) rounds the payload as the JAX wire would: a
bf16 cast of every rank's whole block, or the int8 block-scale round trip
of each block a rank sends, tile by tile.  ``path='auto'`` arbitrates
chain against direct with the tuner's machine constants;
``comm_precision='auto'`` is not a wire and raises ``ValueError``.  On a
device grid the ``'bf16'`` wire casts every rank's block before the moves;
``'int8'``, ``'direct'`` and ``'auto'`` raise ``ValueError`` there.

:func:`collective_sites` names, for any entry, the collectives the JAX
engine's lowering issues on a real grid (primitive, participants, block,
ring-model bytes): the tuner's comm term reads them off a probe's
``redist_trace``.

The fault seam (:func:`fault_injection`, :func:`set_fault_step`,
:func:`apply_fault`) routes the outputs of every public entry, and the
``'compute'`` target of the drivers, through an installed plan.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import Counter
from functools import lru_cache

import numpy as np
import torch

from ..core import indexing as ix
from ..core.dist import (Dist, MC, MR, VC, VR, STAR, MD, CIRC,
                         stride as dist_stride, storage_slot, storage_slots,
                         gather_axes)
from ..core.distmatrix import DistMatrix, _check_pair, from_global, to_global
from ..core import ranks
from ..core.ranks import Tiles, per_rank, refuse
from . import device_route
from .plan import compile_plan
from .quantize import QUANT_TILE, check_comm_precision, q8_roundtrip, quantizable

#: legal values of :func:`redistribute`'s ``path`` argument.  ``None`` and
#: ``'chain'`` are the default route; ``'direct'`` executes the one-shot
#: compiled plan; ``'auto'`` arbitrates per call with the alpha-beta cost.
REDIST_PATHS = (None, "chain", "direct", "auto")

#: Public-entry call counts, keyed by ``(src_dist_pair, dst_dist_pair)``
#: for :func:`redistribute`, ``"panel_spread"`` for :func:`panel_spread`
#: and ``"row_permute"`` for the storage-level row moves.  Counts every
#: entry, a no-op and a 1x1 retag included.
REDIST_COUNTS: Counter = Counter()


@contextlib.contextmanager
def redist_counts():
    """Scoped call counting: swaps a fresh Counter in for
    :data:`REDIST_COUNTS` for the block and yields it; the previous
    counter is restored untouched on exit."""
    global REDIST_COUNTS
    prev = REDIST_COUNTS
    cur: Counter = Counter()
    REDIST_COUNTS = cur
    try:
        yield cur
    finally:
        REDIST_COUNTS = prev


# ---------------------------------------------------------------------
# dist-metadata trace hook
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RedistRecord:
    """One public-entry redistribution call observed under redist_trace."""
    kind: str            # "redistribute" | "panel_spread" | "row_permute"
    src: tuple           # (cdist, rdist) Dist pair of the source
    dst: tuple           # target pair ("panel_spread": the [MC,*]/[*,MR] pair)
    gshape: tuple        # source global shape
    dtype: str           # e.g. "float32"
    in_id: int           # id() of the source local tensor
    out_ids: tuple       # id() of the produced local tensor(s)
    grid_shape: tuple = ()
    #: dtype moved on the wire ("bfloat16" / "int8" under comm_precision)
    wire_dtype: str = ""
    #: route resolved: "chain" (default), "direct" (one-shot plan) or
    #: "storage" (the row-permute path)
    path: str = "chain"
    #: collective rounds of the resolved route on a real grid (-1 = not
    #: computed: a no-op or a misaligned entry)
    rounds: int = -1
    #: ring-model bytes received per device by the resolved route (-1 =
    #: not computed)
    wire_bytes: int = -1
    #: why a ``path='direct'`` / ``'auto'`` request resolved to the chain
    #: ("" = it did not): "noop", "no_plan" or "arbitration"
    fallback_reason: str = ""
    #: ((calign, ralign) of the source, (calign, ralign) of the target):
    #: what :func:`collective_sites` needs to price a misaligned entry
    aligns: tuple = dataclasses.field(default=((0, 0), (0, 0)),
                                      compare=False)
    #: ``_version`` of the source tensor when the entry ran: two entries
    #: on the same ``in_id`` with the same version moved unchanged data
    in_version: int = dataclasses.field(default=-1, compare=False)
    # live references keep the ids above unambiguous (no id reuse after GC)
    refs: tuple = dataclasses.field(default=(), repr=False, compare=False)

    @property
    def label(self) -> str:
        if self.kind != "redistribute":
            return self.kind
        s = f"[{self.src[0].value},{self.src[1].value}]"
        d = f"[{self.dst[0].value},{self.dst[1].value}]"
        return f"{s}->{d}"


_REDIST_TRACE: list | None = None
#: False while an :func:`isolated_probe` measures memory: its records then
#: hold no tensor alive (their ids may be reused after a free)
_TRACE_REFS = True


@contextlib.contextmanager
def redist_trace():
    """Record a :class:`RedistRecord` for every :func:`redistribute` /
    :func:`panel_spread` entry inside the block; yields the live list."""
    global _REDIST_TRACE
    prev = _REDIST_TRACE
    log: list = []
    _REDIST_TRACE = log
    try:
        yield log
    finally:
        _REDIST_TRACE = prev


#: callbacks invoked with every RedistRecord as it happens, whether or not
#: a ``redist_trace`` block is also collecting
_REDIST_OBSERVERS: list = []


def add_redist_observer(cb) -> callable:
    """Register ``cb(record)`` on every public redistribute / panel_spread
    / row-permute entry; returns a zero-argument remover (idempotent)."""
    _REDIST_OBSERVERS.append(cb)

    def remove():
        try:
            _REDIST_OBSERVERS.remove(cb)
        except ValueError:
            pass
    return remove


# ---------------------------------------------------------------------
# fault-injection seam
# ---------------------------------------------------------------------

_FAULT_INJECTOR = None


@contextlib.contextmanager
def fault_injection(plan):
    """Install ``plan`` (anything with ``apply(target, outputs) ->
    outputs``, optionally ``set_step(step)``) as the engine's fault
    injector for the block; the previous injector is restored on exit.
    Every public :func:`redistribute` / :func:`panel_spread` entry routes
    its output local tensor(s) through ``plan.apply``."""
    global _FAULT_INJECTOR
    prev = _FAULT_INJECTOR
    _FAULT_INJECTOR = plan
    try:
        yield plan
    finally:
        _FAULT_INJECTOR = prev


def set_fault_step(step) -> None:
    """Announce the current driver panel step to the installed injector
    (``None`` = leaving the step scope); a no-op without one, or when it
    has no ``set_step``."""
    inj = _FAULT_INJECTOR
    if inj is not None:
        f = getattr(inj, "set_step", None)
        if f is not None:
            f(step)


def apply_fault(target: str, outputs: tuple) -> tuple:
    """Route kernel outputs through the installed fault injector (the
    ``'compute'`` target of the panel factorizations); identity when none
    is installed.  A device grid's outputs (Tiles) take no fault."""
    if _FAULT_INJECTOR is None:
        return tuple(outputs)
    if any(isinstance(o, Tiles) for o in outputs):
        refuse("fault injection")
    return tuple(_FAULT_INJECTOR.apply(target, tuple(outputs)))


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _trace_record(kind, src, dst, gshape, dtype, objs_in, objs_out,
                  grid_shape=(), wire_dtype=None, path="chain", rounds=-1,
                  wire_bytes=-1, fallback_reason="", observers_only=False,
                  aligns=((0, 0), (0, 0))):
    """Build + publish one RedistRecord.  ``observers_only`` keeps it out
    of the ``redist_trace`` list (the row-permute path)."""
    if _REDIST_TRACE is None and not _REDIST_OBSERVERS:
        return
    rec = RedistRecord(
        kind=kind, src=tuple(src), dst=tuple(dst), gshape=tuple(gshape),
        dtype=_dtype_name(dtype), in_id=id(objs_in),
        out_ids=tuple(id(o) for o in objs_out), grid_shape=tuple(grid_shape),
        wire_dtype=wire_dtype or _dtype_name(dtype), path=path,
        rounds=rounds, wire_bytes=wire_bytes,
        fallback_reason=fallback_reason, aligns=tuple(aligns),
        in_version=int(getattr(objs_in, "_version", -1)),
        refs=(objs_in,) + tuple(objs_out))
    if _REDIST_TRACE is not None and not observers_only:
        _REDIST_TRACE.append(rec if _TRACE_REFS
                             else dataclasses.replace(rec, refs=()))
    for cb in tuple(_REDIST_OBSERVERS):
        cb(rec)


def _fault(target: str, local):
    if _FAULT_INJECTOR is None:
        return local
    if isinstance(local, Tiles):
        refuse("fault injection")
    return _FAULT_INJECTOR.apply(target, (local,))[0]


# ---------------------------------------------------------------------
# chain metadata: the collective hops of the JAX engine's dispatch, as
# static data (the virtual grid moves each pair through one index map)
# ---------------------------------------------------------------------

#: Multi-hop routes of the pairs without a dedicated kernel (the fused
#: M<->V all-to-alls plus the [VC]<->[VR] permutation; the reference's
#: ``copy::Exchange`` family)
_CHAINS = {
    ((MC, MR), (MR, MC)): ((VC, STAR), (VR, STAR), (MR, MC)),
    ((MR, MC), (MC, MR)): ((VR, STAR), (VC, STAR), (MC, MR)),
    ((MC, MR), (VR, STAR)): ((VC, STAR), (VR, STAR)),
    ((MC, MR), (STAR, VC)): ((STAR, VR), (STAR, VC)),
    ((VR, STAR), (MC, MR)): ((VC, STAR), (MC, MR)),
    ((STAR, VC), (MC, MR)): ((STAR, VR), (MC, MR)),
    ((MR, MC), (VC, STAR)): ((VR, STAR), (VC, STAR)),
    ((MR, MC), (STAR, VR)): ((STAR, VC), (STAR, VR)),
    ((VC, STAR), (MR, MC)): ((VR, STAR), (MR, MC)),
    ((STAR, VR), (MR, MC)): ((STAR, VC), (MR, MC)),
    ((MC, MR), (MR, STAR)): ((VC, STAR), (VR, STAR), (MR, STAR)),
    ((MC, MR), (STAR, MC)): ((STAR, VR), (STAR, VC), (STAR, MC)),
    ((MR, MC), (MC, STAR)): ((VR, STAR), (VC, STAR), (MC, STAR)),
    ((MR, MC), (STAR, MR)): ((STAR, VC), (STAR, VR), (STAR, MR)),
    ((MR, STAR), (MC, MR)): ((VR, STAR), (VC, STAR), (MC, MR)),
    ((STAR, MC), (MC, MR)): ((STAR, VC), (STAR, VR), (MC, MR)),
    ((MC, STAR), (MR, MC)): ((VC, STAR), (VR, STAR), (MR, MC)),
    ((STAR, MR), (MR, MC)): ((STAR, VR), (STAR, VC), (MR, MC)),
    ((VC, STAR), (MR, STAR)): ((VR, STAR), (MR, STAR)),
    ((VR, STAR), (MC, STAR)): ((VC, STAR), (MC, STAR)),
    ((STAR, VC), (STAR, MR)): ((STAR, VR), (STAR, MR)),
    ((STAR, VR), (STAR, MC)): ((STAR, VC), (STAR, MC)),
}


def _fused_steps(src, dst, r, c):
    """Steps of the JAX engine's fused fast paths, as (kind, participants,
    moving-block dist pair) tuples -- None when no fused kernel applies."""
    if src in ((MC, MR), (MR, MC)) and dst == (STAR, STAR):
        if r > 1 and c > 1:
            return [("ag", r * c, src)]
        return None                         # 1-D grid: generic route
    fused_v = {((MC, MR), (VC, STAR)), ((VC, STAR), (MC, MR)),
               ((MR, MC), (VR, STAR)), ((VR, STAR), (MR, MC)),
               ((MC, MR), (STAR, VR)), ((STAR, VR), (MC, MR)),
               ((MR, MC), (STAR, VC)), ((STAR, VC), (MR, MC))}
    if (src, dst) in fused_v:
        # an all-to-all over the axis the V dist refines along: c
        # participants when VC is the V endpoint, r when VR
        vs = [d for pair in (src, dst) for d in pair if d in (VC, VR)]
        return [("a2a", c if vs[0] is VC else r, src)]
    return None


def _dim_steps(pair, dim, new, r, c):
    """Steps of a single-dim change (gather, filter or the V <-> M partial
    ladder), or None (no fast path)."""
    src_d = pair[dim]
    p = r * c
    if src_d is new:
        return []
    if src_d is STAR:
        return [("local", 1, pair)]
    if new is STAR:
        S = dist_stride(src_d, r, c)
        return [("ag", S, pair)] if S > 1 else [("local", 1, pair)]
    if (src_d, new) in ((VC, MC), (VR, MR)):
        nb = c if src_d is VC else r
        return [("ag", nb, pair)] if nb > 1 else [("local", 1, pair)]
    if (src_d, new) in ((MC, VC), (MR, VR)):
        return [("local", 1, pair)]
    if {src_d, new} == {VC, VR}:
        if p == 1 or r == 1 or c == 1:
            return [("local", 1, pair)]
        return [("ppermute", p, pair)]
    return None


def _chain_steps(src, dst, r, c):
    """The ordered (kind, participants, block pair) collective steps the
    JAX engine's zero-aligned chained route runs for ``src -> dst``."""
    if src == dst:
        return []
    steps = _fused_steps(src, dst, r, c)
    if steps is not None:
        return steps
    if src[0] is dst[0]:
        steps = _dim_steps(src, 1, dst[1], r, c)
        if steps is not None:
            return steps
    if src[1] is dst[1]:
        steps = _dim_steps(src, 0, dst[0], r, c)
        if steps is not None:
            return steps
    route = _CHAINS.get((src, dst))
    if route is not None:
        steps, cur = [], src
        for hop in route:
            steps += _chain_steps(cur, hop, r, c)
            cur = hop
        return steps
    # generic fallback: per-dim gathers through [STAR,STAR], local filter
    steps = []
    for dim, pair in ((0, src), (1, (STAR, src[1]))):
        if pair[dim] is MD:
            steps.append(("ag", r * c, pair))
        elif dist_stride(pair[dim], r, c) > 1:
            steps.append(("ag", dist_stride(pair[dim], r, c), pair))
    return steps


@lru_cache(maxsize=None)
def chain_cost(src, dst, gshape, grid_shape, itemsize):
    """(collective_rounds, ring-model bytes received per device) of the
    chained route for a zero-aligned ``src -> dst`` on a real
    ``grid_shape`` grid."""
    src, dst = tuple(src), tuple(dst)
    r, c = grid_shape
    m, n = gshape
    if src == dst or r * c == 1:
        return 0, 0
    rounds, total = 0, 0
    for kind, S, pair in _chain_steps(src, dst, r, c):
        if kind == "local" or S <= 1:
            continue
        b = (itemsize * ix.max_local_length(m, dist_stride(pair[0], r, c))
             * ix.max_local_length(n, dist_stride(pair[1], r, c)))
        rounds += 1
        if kind == "ag":
            total += b * (S - 1)
        elif kind == "a2a":
            total += b * (S - 1) // S
        else:                                  # ppermute
            total += b
    return rounds, total


# ---------------------------------------------------------------------
# collective sites: the collectives the JAX engine's lowering emits for
# one entry, with their operand blocks and ring-model bytes (what the
# tuner's comm term prices; no jaxpr needed)
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CollectiveSite:
    """One collective of a redistribution on a real r x c grid."""
    prim: str            # all_gather | all_to_all | ppermute | psum
    axis_size: int       # participants (a subgroup's size when grouped)
    shape: tuple         # per-rank operand block
    itemsize: int        # bytes per operand element on the wire
    bytes: int           # ring-model bytes received per rank, one call
    #: mesh axis names the JAX lowering communicates over, in its order
    #: ('mc' = the grid's height, 'mr' = its width)
    axes: tuple = ()
    #: operand dtype on the wire ("" = not named by the caller)
    dtype: str = ""


def ring_bytes(prim: str, nbytes: int, axis_size: int) -> int:
    """Ring-algorithm per-rank received bytes of one collective on an
    ``nbytes`` operand over ``axis_size`` participants (the JAX package's
    ``analysis.jaxpr_walk.estimate_bytes``)."""
    if axis_size <= 1:
        return 0
    if prim == "all_gather":
        return nbytes * (axis_size - 1)
    if prim == "reduce_scatter":
        return nbytes * (axis_size - 1) // axis_size
    if prim == "psum":
        return 2 * nbytes * (axis_size - 1) // axis_size
    if prim == "all_to_all":
        return nbytes * (axis_size - 1) // axis_size
    return nbytes                                  # ppermute


def _site(out: list, prim: str, S: int, shape, z: int, axes,
          dtype: str = "") -> None:
    shape = tuple(int(v) for v in shape)
    nbytes = z * math.prod(shape)
    out.append(CollectiveSite(prim, int(S), shape, int(z),
                              ring_bytes(prim, nbytes, S), tuple(axes),
                              dtype))


def _realign_axes(d: Dist) -> tuple:
    """Axes of the JAX engine's alignment rotation of a ``d`` dimension."""
    return {MC: ("mc",), MR: ("mr",)}.get(d, ("mc", "mr"))


def _lshape(pair, gshape, r, c) -> tuple:
    return (ix.max_local_length(gshape[0], dist_stride(pair[0], r, c)),
            ix.max_local_length(gshape[1], dist_stride(pair[1], r, c)))


def _q8_rows(shape) -> int:
    """Rows of an int8-packed block: the payload plus the f32 tile scales
    bitcast to int8 and appended as whole rows."""
    lr, lc = shape
    tr, tc = -(-lr // QUANT_TILE), -(-lc // QUANT_TILE)
    return lr + -(-tr * tc * 4 // lc)


def _gather_sites(out, pair, dim, gshape, r, c, z, q8=False) -> None:
    """``_gather_dim`` of the JAX engine: one all_gather of the current
    block over the dimension's ranks (none when it is not split)."""
    d = pair[dim]
    S = r * c if d is MD else dist_stride(d, r, c)
    if S == 1:
        return
    shape = _lshape(pair, gshape, r, c)
    if q8:
        _site(out, "all_gather", S, (_q8_rows(shape), shape[1]), 1,
              gather_axes(d))
    else:
        _site(out, "all_gather", S, shape, z, gather_axes(d))


def _star_star_sites(out, src, gshape, r, c, z) -> None:
    _gather_sites(out, src, 0, gshape, r, c, z)
    _gather_sites(out, (STAR, src[1]), 1, gshape, r, c, z)


def _realign_sites(out, pair, gshape, r, c, z, a_old, a_new) -> None:
    for dim in (0, 1):
        S = dist_stride(pair[dim], r, c)
        if S == 1 or a_old[dim] == a_new[dim]:
            continue
        _site(out, "ppermute", S, _lshape(pair, gshape, r, c), z,
              _realign_axes(pair[dim]))


def _fused_sites(out, src, dst, gshape, r, c, z) -> bool:
    """The fused fast paths (one collective each); False when none
    applies."""
    m, n = gshape
    p = r * c
    if src in ((MC, MR), (MR, MC)) and dst == (STAR, STAR):
        if r == 1 or c == 1:
            return False
        _site(out, "all_gather", p, _lshape(src, gshape, r, c), z,
              ("mc", "mr"))
        return True
    if (src, dst) in (((MC, MR), (STAR, VR)), ((MR, MC), (STAR, VC)),
                      ((STAR, VR), (MC, MR)), ((STAR, VC), (MR, MC))):
        # the column forms ride the row kernels on the local transpose
        t = (src[1], src[0]), (dst[1], dst[0])
        return _fused_sites(out, *t, (n, m), r, c, z)
    if (src, dst) in (((MC, MR), (VC, STAR)), ((MR, MC), (VR, STAR))):
        other = c if src[0] is MC else r
        if other > 1:
            lt = ix.max_local_length(m, p)
            lc = _lshape(src, gshape, r, c)[1]
            _site(out, "all_to_all", other, (lt, other, lc), z,
                  ("mr",) if src[0] is MC else ("mc",))
        return True
    if (src, dst) in (((VC, STAR), (MC, MR)), ((VR, STAR), (MR, MC))):
        other = c if src[0] is VC else r
        if other > 1:
            lp = ix.max_local_length(m, p)
            lcd = ix.max_local_length(n, other)
            _site(out, "all_to_all", other, (lp, lcd, other), z,
                  ("mr",) if src[0] is VC else ("mc",))
        return True
    return False


def _dim_sites(out, pair, dim, new, gshape, r, c, z) -> bool:
    """A single-dim change (gather, filter, or the V <-> M ladder); False
    when no fast path applies."""
    src_d = pair[dim]
    if src_d is new or src_d is STAR:
        return True                                # nothing / a filter
    if new is STAR:
        _gather_sites(out, pair, dim, gshape, r, c, z)
        return True
    if (src_d, new) in ((VC, MC), (VR, MR)):
        nb = c if src_d is VC else r
        if nb > 1:
            _site(out, "all_gather", nb, _lshape(pair, gshape, r, c), z,
                  ("mr",) if src_d is VC else ("mc",))
        return True
    if (src_d, new) in ((MC, VC), (MR, VR)):
        return True
    if {src_d, new} == {VC, VR}:
        if r > 1 and c > 1:
            _site(out, "ppermute", r * c, _lshape(pair, gshape, r, c), z,
                  ("mc", "mr"))
        return True
    return False


def _to_dist_sites(out, src, dst, gshape, r, c, z, a_src, a_dst) -> None:
    """Static mirror of the JAX engine's ``to_dist`` dispatch."""
    if src == dst and a_src == a_dst:
        return
    if MD in src + dst:
        _star_star_sites(out, src, gshape, r, c, z)
        return
    if src == dst:
        _realign_sites(out, src, gshape, r, c, z, a_src, a_dst)
        return
    if a_src != (0, 0):
        _realign_sites(out, src, gshape, r, c, z, a_src, (0, 0))
        _to_dist_sites(out, src, dst, gshape, r, c, z, (0, 0), a_dst)
        return
    if a_dst != (0, 0):
        _to_dist_sites(out, src, dst, gshape, r, c, z, (0, 0), (0, 0))
        _realign_sites(out, dst, gshape, r, c, z, (0, 0), a_dst)
        return
    if _fused_sites(out, src, dst, gshape, r, c, z):
        return
    if src[0] is dst[0] and _dim_sites(out, src, 1, dst[1], gshape, r, c, z):
        return
    if src[1] is dst[1] and _dim_sites(out, src, 0, dst[0], gshape, r, c, z):
        return
    route = _CHAINS.get((src, dst))
    if route is not None:
        cur = src
        for hop in route:
            _to_dist_sites(out, cur, hop, gshape, r, c, z, (0, 0), (0, 0))
            cur = hop
        return
    _star_star_sites(out, src, gshape, r, c, z)


def _plan_sites(out, plan, z, wire) -> None:
    """The one collective of a compiled direct plan (none when local)."""
    K = plan.nslots
    R, C = plan.slot_shape
    if plan.kind == "local":
        return
    shape, zz = (K, R, C), z
    if wire == "int8":
        shape, zz = (K, _q8_rows((R, C)), C), 1
    r, c = plan.grid_shape
    S = math.prod(r if a == "mc" else c for a in plan.comm_axes)
    if plan.kind == "a2a":
        _site(out, "all_to_all", len(plan.groups[0]) if plan.groups else S,
              shape, zz, plan.comm_axes)
    else:
        _site(out, "ppermute", S, shape, zz, plan.comm_axes)


def _wire_for(src, grid_shape, mode, q8_ok: bool):
    """The JAX engine's ``_wire_mode`` on metadata alone, for a real
    float payload."""
    check_comm_precision(mode)
    if mode is None or grid_shape[0] * grid_shape[1] == 1 \
            or tuple(src) == (STAR, STAR):
        return None
    if mode == "int8":
        return "int8" if q8_ok else "bf16"
    return "bf16"


def _named(sites: list, wire, dtype: str) -> list:
    """``sites`` with their wire dtype named: the quantized wire's where
    one ran, else the payload's ``dtype``."""
    name = _WIRE_DTYPES.get(wire, dtype)
    return [dataclasses.replace(s, dtype=name) for s in sites]


def collective_sites(src, dst, gshape, grid_shape, itemsize, path=None,
                     comm_precision=None, aligns=((0, 0), (0, 0)),
                     dtype: str = "") -> list:
    """The collectives the JAX engine issues for ``redistribute(A[src] ->
    dst)`` on a real ``grid_shape`` grid, as :class:`CollectiveSite` s.

    ``path`` is a resolved route (a record holds the one it ran): a no-op
    issues none; ``'direct'`` runs the compiled plan's one collective
    where there is a plan; otherwise the factored hops of the ``to_dist``
    dispatch, each with the block it moves.  A CIRC target gathers to
    [STAR,STAR]; a CIRC source is a local filter.  ``comm_precision``
    narrows the wire of a real float payload as ``_wire_mode`` does (an
    int8 gather moves the packed block, scales included).  ``dtype``
    names the payload; each site carries its wire dtype."""
    src, dst = tuple(src), tuple(dst)
    r, c = grid_shape
    a_src, a_dst = tuple(aligns[0]), tuple(aligns[1])
    z = int(itemsize)
    out: list = []
    noop = src == dst and a_src == a_dst
    circ = src[0] is CIRC or dst[0] is CIRC
    if path == "direct" and not noop:
        plan = compile_plan(src, dst, tuple(gshape), (r, c), a_src, a_dst)
        if plan is not None and not circ:
            wire = None if plan.kind == "local" else _wire_for(
                src, grid_shape, comm_precision, True)
            zw = {"bf16": 2}.get(wire, z)
            _plan_sites(out, plan, zw, wire)
            return _named(out, wire, dtype)
    if circ:
        if src[0] is CIRC and dst[0] is CIRC:
            return out
        if dst[0] is CIRC:
            _to_dist_sites(out, src, (STAR, STAR), gshape, r, c, z, a_src,
                           (0, 0))
        else:
            _to_dist_sites(out, (STAR, STAR), dst, gshape, r, c, z, (0, 0),
                           a_dst)
        return _named(out, None, dtype)
    if noop:
        return out
    q8_ok = (dst == (STAR, STAR) and a_dst == (0, 0) and a_src == (0, 0)
             and set(src) <= _Q8_DISTS)
    wire = _wire_for(src, grid_shape, comm_precision, q8_ok)
    if wire == "int8":
        if src in ((MC, MR), (MR, MC)) and r > 1 and c > 1:
            sh = _lshape(src, gshape, r, c)
            _site(out, "all_gather", r * c, (_q8_rows(sh), sh[1]), 1,
                  ("mc", "mr"))
        else:
            _gather_sites(out, src, 0, gshape, r, c, z, q8=True)
            _gather_sites(out, (STAR, src[1]), 1, gshape, r, c, z, q8=True)
        return _named(out, wire, dtype)
    _to_dist_sites(out, src, dst, gshape, r, c,
                   2 if wire == "bf16" else z, a_src, a_dst)
    return _named(out, wire, dtype)


def panel_spread_sites(gshape, grid_shape, itemsize,
                       comm_precision=None, dtype: str = "") -> list:
    """The one all_gather of :func:`panel_spread` on a real grid: the
    [VC,STAR] panel gathered over all p ranks."""
    r, c = grid_shape
    wire = _wire_for((VC, STAR), grid_shape, comm_precision, True)
    out: list = []
    _gather_sites(out, (VC, STAR), 0, gshape, r, c,
                  2 if wire == "bf16" else int(itemsize), q8=wire == "int8")
    return _named(out, wire, dtype)


def record_sites(rec) -> list:
    """:func:`collective_sites` of one :class:`RedistRecord`, at the wire
    the entry ran."""
    itemsize = getattr(torch, rec.dtype).itemsize
    mode = {"bfloat16": "bf16", "int8": "int8"}.get(rec.wire_dtype)
    if rec.kind == "panel_spread":
        return panel_spread_sites(rec.gshape, rec.grid_shape, itemsize, mode,
                                  dtype=rec.dtype)
    if rec.kind != "redistribute":
        return []
    path = rec.path if rec.path == "direct" else None
    return collective_sites(rec.src, rec.dst, rec.gshape, rec.grid_shape,
                            itemsize, path=path, comm_precision=mode,
                            aligns=rec.aligns, dtype=rec.dtype)


#: explicit collectives of the drivers themselves (CALU's row-block psum),
#: collected inside :func:`isolated_probe`; None = not collecting
_COLLECTIVE_LOG: list | None = None


def note_collective(prim: str, axis_size: int, shape, itemsize: int,
                    axes=(), dtype: str = "") -> None:
    """Announce a driver-level collective a real grid would run over the
    mesh ``axes`` with a ``dtype`` payload (no-op unless a log is
    collecting)."""
    if _COLLECTIVE_LOG is not None:
        _site(_COLLECTIVE_LOG, prim, axis_size, shape, itemsize, axes, dtype)



@contextlib.contextmanager
def isolated_probe(refs: bool = True):
    """Run a probe call unseen: fresh ``redist_counts`` and
    ``redist_trace`` (yielded with the driver-level collective log as
    ``(trace, log)``), no redistribution observers, no installed fault
    plan, and a throwaway metrics registry; the caller's state comes back
    untouched on exit.  ``refs=False`` records without keeping the
    recorded tensors alive (a memory measurement's probe)."""
    global _REDIST_OBSERVERS, _FAULT_INJECTOR, _COLLECTIVE_LOG, _TRACE_REFS
    from ..obs import metrics as _metrics
    saved = (_REDIST_OBSERVERS, _FAULT_INJECTOR, _COLLECTIVE_LOG,
             _TRACE_REFS)
    _REDIST_OBSERVERS, _FAULT_INJECTOR, _COLLECTIVE_LOG = [], None, []
    _TRACE_REFS = bool(refs)
    log = _COLLECTIVE_LOG
    try:
        with redist_counts(), redist_trace() as trace, _metrics.scoped():
            yield trace, log
    finally:
        (_REDIST_OBSERVERS, _FAULT_INJECTOR, _COLLECTIVE_LOG,
         _TRACE_REFS) = saved


# ---------------------------------------------------------------------
# the default route: through the global matrix
# ---------------------------------------------------------------------

def _fresh(A: DistMatrix) -> DistMatrix:
    """``A`` with a new view of the same storage (a record's output is
    never the object that went in)."""
    return A.with_local(per_rank(lambda rk, x: x.view(x.shape), A.local))


def _global_route(A: DistMatrix, cdist: Dist, rdist: Dist, calign: int,
                  ralign: int) -> DistMatrix:
    if A.dist == (cdist, rdist) and (A.calign, A.ralign) == (calign, ralign):
        return _fresh(A)
    if A.grid.size == 1:
        # every layout's storage is the global matrix on a 1x1 grid
        return DistMatrix(_fresh(A).local, A.gshape, cdist,
                          rdist, 0 if cdist is CIRC else calign,
                          0 if cdist is CIRC else ralign, A.grid)
    return from_global(to_global(A), cdist, rdist, A.grid, calign, ralign)


def to_star_star(A: DistMatrix) -> DistMatrix:
    return redistribute(A, STAR, STAR)


def _from_star_star(xg, gshape, cdist, rdist, calign, ralign, grid) -> DistMatrix:
    if tuple(xg.shape) != tuple(gshape):
        raise ValueError(f"[STAR,STAR] array {tuple(xg.shape)} != {gshape}")
    return from_global(xg, cdist, rdist, grid, calign, ralign)


# ---------------------------------------------------------------------
# quantized wire precision
# ---------------------------------------------------------------------

#: wire dtype names recorded on RedistRecord per resolved mode
_WIRE_DTYPES = {"bf16": "bfloat16", "int8": "int8"}

#: dists the int8 gather family understands
_Q8_DISTS = frozenset({MC, MR, VC, VR, STAR})


def _wire_mode(A: DistMatrix, mode, q8_ok: bool):
    """Resolve a requested ``comm_precision`` to the wire mode actually
    run: ``None`` on 1x1 grids, non-real-float payloads and replicated
    sources (nothing crosses a wire there); ``'int8'`` only where the
    int8 gather family applies (``q8_ok``), ``'bf16'`` otherwise."""
    check_comm_precision(mode)
    if mode is None:
        return None
    if A.grid.size == 1 or not quantizable(A.dtype):
        return None
    if A.dist == (STAR, STAR):
        return None
    if mode == "int8":
        return "int8" if q8_ok else "bf16"
    return "bf16"


def _bf16(x):
    """The bf16 wire: every entry of a rank's block is cast, the ones the
    rank keeps included."""
    return x.to(torch.bfloat16).to(x.dtype)


def _q8_tiles(x, slots_r: int, slots_c: int):
    """Per-block int8 round trip of a stacked storage split into
    ``slots_r x slots_c`` rank blocks (what each rank's block is after it
    crossed the int8 wire)."""
    lr, lc = x.shape[0] // slots_r, x.shape[1] // slots_c
    if lr == 0 or lc == 0:
        return x
    b = x.reshape(slots_r, lr, slots_c, lc).permute(0, 2, 1, 3)
    b = q8_roundtrip(b, QUANT_TILE, reciprocal=True)
    return b.permute(0, 2, 1, 3).reshape(x.shape)


def _gather_dim_q8(A: DistMatrix, dim: int) -> DistMatrix:
    """Gather one distributed dimension of a zero-aligned matrix to STAR
    over the int8 wire: every rank block of the gathered dimension is
    round-tripped, then the values are laid out replicated."""
    g = A.grid
    r, c = g.height, g.width
    d = A.dist[dim]
    if dist_stride(d, r, c) == 1:
        return A
    sr = storage_slots(A.cdist, r, c)
    sc = storage_slots(A.rdist, r, c)
    x = _q8_tiles(A.local, sr, sc)
    new = (STAR, A.rdist) if dim == 0 else (A.cdist, STAR)
    return from_global(to_global(A.with_local(x)), *new, g)


def _to_star_star_q8(A: DistMatrix) -> DistMatrix:
    """[*,*] over the int8 wire: the fused 2-D gather (one round trip of
    each rank block) on a 2-D grid from [MC,MR] / [MR,MC], else one
    gather per distributed dimension, each round-tripping the blocks it
    moves."""
    g = A.grid
    r, c = g.height, g.width
    if A.dist in ((MC, MR), (MR, MC)) and r > 1 and c > 1:
        x = _q8_tiles(A.local, r if A.cdist is MC else c,
                      c if A.rdist is MR else r)
        return DistMatrix(to_global(A.with_local(x)), A.gshape, STAR, STAR,
                          0, 0, g)
    out = _gather_dim_q8(_gather_dim_q8(A, 0), 1)
    return DistMatrix(to_global(out), A.gshape, STAR, STAR, 0, 0, g)


# ---------------------------------------------------------------------
# one-shot direct path: the compiled plan's index maps on the storage
# ---------------------------------------------------------------------

def direct_plan_for(A: DistMatrix, cdist: Dist, rdist: Dist,
                    calign: int = 0, ralign: int = 0):
    """The compiled one-shot plan for this redistribution, or None when no
    plan applies (a no-op, or an MD endpoint at nonzero alignments)."""
    return compile_plan(A.dist, (cdist, rdist), A.gshape,
                        (A.grid.height, A.grid.width),
                        (A.calign, A.ralign), (calign, ralign))


def _machine_terms(grid_shape=None, backend: str = "cpu"):
    """(latency_s, bw_bytes_per_s) of the alpha-beta arbitration.

    Measured ``redist_constants/v1`` for this (grid, backend) take
    precedence over the tuner's static machine model
    (:func:`..tune.cost_model.machine_for`)."""
    if grid_shape is not None:
        from ..tune.cache import load_redist_constants
        doc = load_redist_constants(tuple(grid_shape), backend)
        if doc is not None:
            return float(doc["alpha_s"]), float(doc["bw_bytes_per_s"])
    from ..tune.cost_model import machine_for
    mm = machine_for(backend)
    return mm.latency_s, mm.bw_bytes_per_s


def _direct_wins(plan, gshape, itemsize, backend: str = "cpu") -> bool:
    """``path='auto'`` arbitration: alpha-beta (latency x rounds + bytes /
    bandwidth) of the one-shot plan against the chained route, with the
    measured per-(grid, backend) constants when they are recorded; ties go
    to the chain (the bit-identical default)."""
    rounds_c, bytes_c = chain_cost(plan.src, plan.dst, gshape,
                                   plan.grid_shape, itemsize)
    if rounds_c == 0:
        return False
    lat, bw = _machine_terms(plan.grid_shape, backend)
    t_direct = lat * plan.rounds + plan.wire_bytes(itemsize) / bw
    t_chain = lat * rounds_c + bytes_c / bw
    return t_direct < t_chain


@lru_cache(maxsize=256)
def _direct_maps(plan):
    """The plan's per-device gather -> collective -> scatter, composed
    into storage index maps on the virtual grid.

    For one representative device of every destination block and each of
    its K receive slots: the source storage rows/cols the slot's values
    come from (the canonical sender's send maps; the sentinel marks a
    zero) and the destination storage rows/cols they land on (the
    receiver's recv maps; the sentinel drops).  Returns numpy arrays
    ``(src_rows, src_cols, dst_rows, dst_cols)`` of shape (B, K, R) /
    (B, K, C), with the sentinel replaced by the storage extent."""
    r, c = plan.grid_shape
    p = r * c
    comm = plan.comm_axes
    sizes = {"mc": r, "mr": c}
    lr_s, lc_s = plan.src_local
    lr_d, lc_d = plan.dst_local
    src_ext = (storage_slots(plan.src[0], r, c) * lr_s,
               storage_slots(plan.src[1], r, c) * lc_s)
    dst_ext = (storage_slots(plan.dst[0], r, c) * lr_d,
               storage_slots(plan.dst[1], r, c) * lc_d)

    def peer(d, k):
        cs = {"mc": d // c, "mr": d % c}
        for a in reversed(comm):
            cs[a] = k % sizes[a]
            k //= sizes[a]
        return cs["mc"] * c + cs["mr"]

    def pidx(d):
        cs = {"mc": d // c, "mr": d % c}
        k = 0
        for a in comm:
            k = k * sizes[a] + cs[a]
        return k

    def source(d, k):
        """(sender device, sender slot) of receiver d's slot k, or None."""
        if plan.kind == "local":
            return d, k
        if plan.kind == "ppermute":
            for s, t in plan.perm:
                if t == pidx(d):
                    return peer(d, s), 0
            return None
        if plan.groups:
            grp = next(g for g in plan.groups if pidx(d) in g)
            return peer(d, grp[k]), grp.index(pidx(d))
        return peer(d, k), pidx(d)

    reps, seen = [], set()
    for d in range(p):
        mc, mr = d // c, d % c
        key = (storage_slot(plan.dst[0], r, c, mc, mr),
               storage_slot(plan.dst[1], r, c, mc, mr))
        if key not in seen:
            seen.add(key)
            reps.append((d, key))
    K = plan.nslots
    R, C = plan.slot_shape
    src_rows = np.full((len(reps), K, R), src_ext[0], np.int64)
    src_cols = np.full((len(reps), K, C), src_ext[1], np.int64)
    dst_rows = np.full((len(reps), K, R), dst_ext[0], np.int64)
    dst_cols = np.full((len(reps), K, C), dst_ext[1], np.int64)
    for b, (d, (tr, tc)) in enumerate(reps):
        rr, rc = plan.recv_rows[d], plan.recv_cols[d]
        dst_rows[b] = np.where(rr < lr_d, tr * lr_d + rr, dst_ext[0])
        dst_cols[b] = np.where(rc < lc_d, tc * lc_d + rc, dst_ext[1])
        for k in range(K):
            sk = source(d, k)
            if sk is None:
                continue
            s, slot = sk
            smc, smr = s // c, s % c
            sr_, sc_ = plan.send_rows[s, slot], plan.send_cols[s, slot]
            str_ = storage_slot(plan.src[0], r, c, smc, smr)
            stc = storage_slot(plan.src[1], r, c, smc, smr)
            src_rows[b, k] = np.where(sr_ < lr_s, str_ * lr_s + sr_,
                                      src_ext[0])
            src_cols[b, k] = np.where(sc_ < lc_s, stc * lc_s + sc_,
                                      src_ext[1])
    return src_rows, src_cols, dst_rows, dst_cols, dst_ext


def _direct_exec(A: DistMatrix, plan, wire, cdist, rdist, calign,
                 ralign) -> DistMatrix:
    """Execute a compiled plan on the stacked storage: the senders' slot
    gathers (sentinels read zero), the int8 round trip of every slot on
    an int8 wire, and the receivers' scatter onto zeros (sentinels
    drop)."""
    src_rows, src_cols, dst_rows, dst_cols, dst_ext = _direct_maps(plan)
    x = A.local
    dt = x.dtype
    dev = x.device
    if wire == "bf16":
        x = x.to(torch.bfloat16)
    xp = torch.nn.functional.pad(x, (0, 1, 0, 1))     # the zero sentinel
    t = lambda a: torch.as_tensor(a, device=dev)     # noqa: E731
    vals = xp[t(src_rows)[:, :, :, None], t(src_cols)[:, :, None, :]]
    if wire == "int8" and plan.kind != "local":
        vals = q8_roundtrip(vals, QUANT_TILE, reciprocal=True)
    out = torch.zeros((dst_ext[0] + 1, dst_ext[1] + 1), dtype=vals.dtype,
                      device=dev)
    out[t(dst_rows)[:, :, :, None], t(dst_cols)[:, :, None, :]] = vals
    loc = out[:-1, :-1].to(dt)
    return DistMatrix(loc, A.gshape, cdist, rdist, calign, ralign, A.grid)


# ---------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------

def redistribute(A: DistMatrix, cdist: Dist, rdist: Dist,
                 calign: int = 0, ralign: int = 0,
                 comm_precision=None, path=None) -> DistMatrix:
    """``B[cdist,rdist] = A`` (``Copy(A, B)`` of the reference).

    ``comm_precision`` (``None`` | ``'bf16'`` | ``'int8'``) rounds the
    payload as the JAX engine's wire does: ``'bf16'`` applies to every
    pair, ``'int8'`` to the zero-aligned gather-to-[STAR,STAR] family
    (and every slot of a direct plan) and falls back to ``'bf16'``
    elsewhere; the knob is a no-op on 1x1 grids, non-real-float payloads
    and replicated sources.  ``path`` (:data:`REDIST_PATHS`): ``None`` /
    ``'chain'`` take the global route, ``'direct'`` executes the one-shot
    compiled plan (a no-op falls back to the chain with
    ``fallback_reason='noop'``), ``'auto'`` compiles the plan and takes it
    only where the alpha-beta cost (:func:`_direct_wins`: measured
    ``redist_constants/v1`` for this grid and backend, else the tuner's
    machine model) says it beats the chain
    (``fallback_reason='arbitration'`` otherwise).  Every fallback
    increments the ``redist_fallbacks{reason}`` counter of
    :mod:`..obs.metrics`.  ``comm_precision='auto'`` raises
    ``ValueError``: the tuner resolves that knob inside the drivers."""
    _check_pair(cdist, rdist)
    if path not in REDIST_PATHS:
        raise ValueError(f"path must be one of {REDIST_PATHS}, got {path!r}")
    check_comm_precision(comm_precision)
    ranked = isinstance(A.local, Tiles)
    if ranked:
        _device_knobs(comm_precision, path)
    REDIST_COUNTS[(A.dist, (cdist, rdist))] += 1
    grid_shape = (A.grid.height, A.grid.width)
    itemsize = A.dtype.itemsize
    circ = cdist is CIRC or A.cdist is CIRC
    noop = A.dist == (cdist, rdist) \
        and (A.calign, A.ralign) == (calign, ralign)
    plan = None
    fallback_reason = ""
    if path in ("direct", "auto"):
        if noop:
            fallback_reason = "noop"
        else:
            plan = direct_plan_for(A, cdist, rdist, calign, ralign)
            if plan is None:
                fallback_reason = "no_plan"
            elif path == "auto" and plan.kind != "bridge" and \
                    not _direct_wins(plan, A.gshape, itemsize,
                                     backend_of(A.grid)):
                plan, fallback_reason = None, "arbitration"
    if fallback_reason:
        from ..obs import metrics as _metrics
        _metrics.inc("redist_fallbacks", reason=fallback_reason)
    aligns = ((A.calign, A.ralign), (calign, ralign))
    if plan is not None and not circ:
        wire = None if plan.kind == "local" \
            else _wire_mode(A, comm_precision, q8_ok=True)
        out = _direct_exec(A, plan, wire, cdist, rdist, calign, ralign)
        out = out.with_local(_fault("redistribute", out.local))
        wire_sz = {"bf16": 2, "int8": 1}.get(wire, itemsize)
        _trace_record("redistribute", A.dist, (cdist, rdist), A.gshape,
                      A.dtype, A.local, (out.local,), grid_shape=grid_shape,
                      wire_dtype=_WIRE_DTYPES.get(wire), path="direct",
                      rounds=plan.rounds, wire_bytes=plan.wire_bytes(wire_sz),
                      aligns=aligns)
        return out
    wire = None
    if not circ:
        q8_ok = ((cdist, rdist) == (STAR, STAR)
                 and (calign, ralign) == (0, 0) and _zero_aligned(A)
                 and set(A.dist) <= _Q8_DISTS)
        wire = None if noop else _wire_mode(A, comm_precision, q8_ok)
    if ranked and A.grid.size > 1 and not noop:
        out = device_route.redistribute(A, cdist, rdist, calign, ralign, wire)
    elif circ or ranked:
        out = _global_route(A, cdist, rdist, calign, ralign)
    else:
        if wire == "int8":
            out = _to_star_star_q8(A)
        elif wire == "bf16":
            out = _global_route(A.with_local(_bf16(A.local)), cdist, rdist,
                                calign, ralign)
        else:
            out = _global_route(A, cdist, rdist, calign, ralign)
    out = out.with_local(_fault("redistribute", out.local))
    if plan is not None:
        # a CIRC bridge under 'direct': the global route above, recorded as
        # the direct route with the plan's full-matrix cost
        _trace_record("redistribute", A.dist, (cdist, rdist), A.gshape,
                      A.dtype, A.local, (out.local,), grid_shape=grid_shape,
                      wire_dtype=_WIRE_DTYPES.get(wire), path="direct",
                      rounds=plan.rounds, wire_bytes=plan.wire_bytes(itemsize),
                      aligns=aligns)
        return out
    rounds = wire_bytes = -1
    if not circ and not noop and _zero_aligned(A) and (calign, ralign) == (0, 0):
        wire_sz = {"bf16": 2, "int8": 1}.get(wire, itemsize)
        rounds, wire_bytes = chain_cost(A.dist, (cdist, rdist), A.gshape,
                                        grid_shape, wire_sz)
    _trace_record("redistribute", A.dist, (cdist, rdist), A.gshape,
                  A.dtype, A.local, (out.local,), grid_shape=grid_shape,
                  wire_dtype=_WIRE_DTYPES.get(wire), path="chain",
                  rounds=rounds, wire_bytes=wire_bytes,
                  fallback_reason=fallback_reason, aligns=aligns)
    return out


def _device_knobs(comm_precision, path) -> None:
    """The wire and route knobs a device grid runs: the full-precision and
    ``'bf16'`` wires on the chained route."""
    if comm_precision == "int8":
        raise ValueError("comm_precision='int8' does not run on a device "
                         "grid yet (its wire is a later slice); use None or "
                         "'bf16'")
    if path in ("direct", "auto"):
        raise ValueError(f"path={path!r} does not run on a device grid yet "
                         f"(the one-shot plan's executor is a later slice); "
                         f"use None or 'chain'")


def backend_of(grid) -> str:
    """The backend word of a grid's devices, the JAX package's: ``'gpu'``
    for CUDA devices, ``'cpu'`` for the CPU (the tuner's cache file
    names and machine rows use these words)."""
    dev = grid.devices[0] if grid.devices is not None else grid.device
    return "gpu" if dev.type == "cuda" else dev.type


def _zero_aligned(A: DistMatrix) -> bool:
    return A.calign == 0 and A.ralign == 0


def transpose_dist(A: DistMatrix, conj: bool = False) -> DistMatrix:
    """A^T tagged [rdist, cdist] -- Elemental's ``copy::TransposeDist``
    (a local transpose of the storage, materialized; on a device grid of
    every rank's block)."""
    if isinstance(A.local, Tiles):
        return device_route.transpose_dist(A, conj)
    loc = A.local.mT.contiguous()
    if conj:
        loc = loc.conj_physical()
    m, n = A.gshape
    return DistMatrix(loc, (n, m), A.rdist, A.cdist, A.ralign, A.calign, A.grid)


def panel_spread(A: DistMatrix, conj: bool = True, comm_precision=None):
    """``(A -> [MC,STAR],  op(A)^T -> [STAR,MR])`` for a zero-aligned
    [VC,STAR] panel: the operand pair of the Hermitian rank-k update
    (``conj=True`` gives the adjoint ``A^H``, ``False`` the transpose),
    one collective round on a real grid.  ``comm_precision`` rounds the
    gathered panel as the JAX wire does (int8: each VC block's round
    trip)."""
    if A.dist != (VC, STAR) or (A.calign, A.ralign) != (0, 0):
        raise ValueError(f"panel_spread needs a zero-aligned [VC,STAR] "
                         f"panel, got {A}")
    ranked = isinstance(A.local, Tiles)
    if ranked:
        _device_knobs(comm_precision, None)
    REDIST_COUNTS["panel_spread"] += 1
    wire = _wire_mode(A, comm_precision, q8_ok=True)
    g = A.grid
    src = A
    if ranked:
        mc, mr = device_route.panel_spread(A, conj, wire)
    else:
        if wire == "int8":
            src = A.with_local(_q8_tiles(A.local, g.size, 1))
        elif wire == "bf16":
            src = A.with_local(_bf16(A.local))
        mc = _global_route(src, MC, STAR, 0, 0)
        mr = _global_route(transpose_dist(src, conj=conj), STAR, MR, 0, 0)
    if _FAULT_INJECTOR is not None:
        if ranked:
            refuse("fault injection")
        lmc, lmr = _FAULT_INJECTOR.apply("panel_spread", (mc.local, mr.local))
        mc, mr = mc.with_local(lmc), mr.with_local(lmr)
    _trace_record("panel_spread", A.dist, ((MC, STAR), (STAR, MR)),
                  A.gshape, A.dtype, A.local, (mc.local, mr.local),
                  grid_shape=(g.height, g.width),
                  wire_dtype=_WIRE_DTYPES.get(wire))
    return mc, mr


# ---------------------------------------------------------------------
# Contract / SumScatter (partial products -> distributed sum)
# ---------------------------------------------------------------------

#: the (source, target) pairs of :func:`contract`
_CONTRACT_PAIRS = frozenset({
    ((MC, STAR), (MC, MR)), ((STAR, MR), (MC, MR)),
    ((MR, STAR), (MR, MC)), ((STAR, MC), (MR, MC)),
    ((STAR, STAR), (MC, MR)), ((STAR, STAR), (STAR, STAR)),
    ((STAR, STAR), (VC, STAR)),
})


def contract(A: DistMatrix, cdist: Dist, rdist: Dist) -> DistMatrix:
    """Sum partial contributions held per rank and land on [cdist,rdist]
    (the reference's ``Contract`` / ``AxpyContract``, a ReduceScatter on
    a real grid).

    The virtual grid's storage holds one copy per owning rank, so the
    partials come explicitly: ``A.local`` has a leading axis of length p,
    entry ``d`` the stacked storage of device ``d = mc * c + mr``, of
    which only device d's own block counts.  The blocks are summed in
    ascending device order.  Zero alignments."""
    if isinstance(A.local, Tiles):
        refuse("contract")
    g = A.grid
    r, c = g.height, g.width
    src, dst = A.dist, (cdist, rdist)
    if (src, dst) not in _CONTRACT_PAIRS:
        raise NotImplementedError(f"contract {src} -> {dst}")
    parts = A.local
    if parts.shape[0] != r * c:
        raise ValueError(f"contract needs {r * c} partial storages, got "
                         f"{parts.shape[0]}")
    sr, sc = storage_slots(A.cdist, r, c), storage_slots(A.rdist, r, c)
    lr, lc = parts.shape[1] // sr, parts.shape[2] // sc
    total = None
    for d in range(r * c):
        mc, mr = d // c, d % c
        tr = storage_slot(A.cdist, r, c, mc, mr)
        tc = storage_slot(A.rdist, r, c, mc, mr)
        own = torch.zeros_like(parts[d])
        own[tr * lr:(tr + 1) * lr, tc * lc:(tc + 1) * lc] = \
            parts[d, tr * lr:(tr + 1) * lr, tc * lc:(tc + 1) * lc]
        gl = to_global(DistMatrix(own, A.gshape, A.cdist, A.rdist, 0, 0, g))
        total = gl if total is None else total + gl
    return from_global(total, cdist, rdist, g)


# ---------------------------------------------------------------------
# batched storage-level row permutations
# ---------------------------------------------------------------------

def _storage_row_of(i, S: int, lr: int):
    """Storage row of global row i for a stride-S zero-aligned column dim
    (stacked-storage layout: slot-major, then local offset)."""
    if S == 1:
        return i
    return (i % S) * lr + i // S


def _index(x, device):
    return torch.as_tensor(x, device=device).to(torch.int64)


def move_rows(A: DistMatrix, targets, sources, valid) -> DistMatrix:
    """Move global rows ``sources`` to positions ``targets`` in one
    storage-level gather/scatter, dropping entries where ``valid`` is
    False (sentinel padding), as the JAX engine's ``mode="drop"`` scatter
    does.  Invalid entries scatter into one spare storage row that is
    sliced off, so nothing syncs with the host.

    On a device grid (an [MC,*] matrix) the indices are every rank's own
    copy (a Tiles; a tensor is handed to the ranks by
    :func:`~..core.ranks.replicate`) and the rows move within each grid
    column through :func:`~..core.ranks.gather_rows`; the record is the
    virtual grid's."""
    ranked = isinstance(A.local, Tiles)
    if ranked:
        _check_mc_rows(A, "move_rows")
    REDIST_COUNTS["row_permute"] += 1
    S, lr = A.col_stride, A.local_rows
    m = A.gshape[0]
    if ranked:
        targets, sources, valid = (ranks.replicate(A.grid, x) for x in
                                   (targets, sources, valid))
        rows = ranks.gather_rows(A.local, per_rank(
            lambda rk, s: _index(s, s.device).clamp(0, m - 1), sources))

        def land(rk, x, t, v, y):
            # the rank's own rows of the valid targets; the rest go to
            # the spare row
            t = _index(t, x.device)
            mine = v & (t % S == rk[0])
            out = torch.cat((x, x.new_zeros((1, x.shape[1]))))
            out.index_copy_(0, torch.where(mine, t.clamp(0, m - 1) // S,
                                           x.shape[0]), y)
            return out[:-1]
        res = A.with_local(per_rank(land, A.local, targets, valid, rows))
        k = int(targets.tiles[0].shape[0])
        width = A.row_stride * A.local_cols
    else:
        dev = A.local.device
        targets, sources = _index(targets, dev), _index(sources, dev)
        valid = torch.as_tensor(valid, device=dev)
        stor = A.local
        sidx = _storage_row_of(targets.clamp(0, m - 1), S, lr)
        sidx = torch.where(valid, sidx, stor.shape[0])     # the spare row
        rows = stor.index_select(
            0, _storage_row_of(sources.clamp(0, m - 1), S, lr))
        out = torch.cat((stor, stor.new_zeros((1, stor.shape[1]))))
        out.index_copy_(0, sidx, rows)
        res = A.with_local(out[:-1])
        k = int(targets.shape[0])
        width = stor.shape[1]
    _trace_record("row_permute", A.dist, A.dist, (k, A.gshape[1]), A.dtype,
                  A.local, (res.local,), grid_shape=(A.grid.height,
                                                     A.grid.width),
                  path="storage", rounds=0,
                  wire_bytes=k * width * A.dtype.itemsize,
                  observers_only=True)
    return res


def _check_mc_rows(A: DistMatrix, what: str) -> None:
    """The row motions run on a device grid for a zero-aligned [MC,*]
    matrix (the LU drivers' [MC,MR])."""
    if A.cdist is not MC or A.calign:
        raise ranks.DeviceGridError(f"{what} runs on a device grid for "
                                    f"zero-aligned [MC,*] matrices, got {A}")


def permute_rows_storage(A: DistMatrix, perm, inverse: bool = False
                         ) -> DistMatrix:
    """``B[i] = A[perm[i]]`` as one storage-level gather for a zero-aligned
    row-cyclic matrix (the full-permutation sibling of :func:`move_rows`);
    padding rows stay zero.  On a device grid (an [MC,*] matrix) each rank
    gathers its own rows from its grid column
    (:func:`~..core.ranks.gather_rows`), its copy of ``perm`` as
    :func:`move_rows` takes its indices; the record is the virtual
    grid's."""
    if (A.calign, A.ralign) != (0, 0):
        raise ValueError(f"permute_rows_storage needs zero alignments, got {A}")
    ranked = isinstance(A.local, Tiles)
    if ranked:
        _check_mc_rows(A, "permute_rows_storage")
    REDIST_COUNTS["row_permute"] += 1
    m = A.gshape[0]
    S, lr = A.col_stride, A.local_rows
    if ranked:
        def mine(rk, q):
            # the global row of each local row, and its source row
            q = _index(q, q.device)
            p = torch.argsort(q) if inverse else q
            gi = torch.arange(lr, device=q.device) * S + rk[0]
            return gi, p[gi.clamp(0, m - 1)]
        gi, src = per_rank(mine, ranks.replicate(A.grid, perm))
        res = A.with_local(per_rank(
            lambda rk, y, i: torch.where((i < m)[:, None], y, 0),
            ranks.gather_rows(A.local, src), gi))
        size = S * lr * A.row_stride * A.local_cols
    else:
        dev = A.local.device
        perm = _index(perm, dev)
        p = torch.argsort(perm) if inverse else perm
        if S == 1:
            res = A.with_local(A.local.index_select(0, p))
        else:
            sr = torch.arange(S * lr, device=dev)
            gi = (sr % lr) * S + sr // lr           # global row of storage slot
            src = _storage_row_of(p[gi.clamp(0, m - 1)], S, lr)
            out = A.local.index_select(0, src)
            res = A.with_local(torch.where((gi < m)[:, None], out, 0))
        size = A.local.numel()
    _trace_record("row_permute", A.dist, A.dist, A.gshape, A.dtype,
                  A.local, (res.local,), grid_shape=(A.grid.height,
                                                     A.grid.width),
                  path="storage", rounds=0,
                  wire_bytes=size * A.dtype.itemsize,
                  observers_only=True)
    return res
