"""Analytic cost model: score a knob configuration WITHOUT executing it
on the card.

PyTorch port of ``elemental_tpu/tune/cost_model.py``.  The terms are the
JAX model's:

* **Communication** -- for the blocked factorizations and solves
  (``cholesky``/``lu``/``qr``/``trsm``/``herk``) the schedule is what the
  knobs change, so the model does not guess it.  The JAX model traces the
  driver to a jaxpr and reads its collectives; the port has no jaxpr, so
  it runs the port's own driver once (a *probe*) on a CPU grid of the
  same r x c at the trace geometry, and maps every entry the probe's
  ``redist_trace`` records to the collectives the JAX lowering emits for
  it (:func:`~elemental_tpu_torch.redist.engine.collective_sites`: the
  primitive, its participants, the block, the ring-model bytes), plus the
  driver-level collectives no hop records (CALU's row-block psum).
  Problems larger than :data:`TRACE_REAL_LIMIT` probe at a
  ratio-preserving scaled geometry and extrapolate: latency scales with
  the real step count, bytes with the real matrix area.  For ``gemm`` the
  per-alg comm plans are closed-form ring-model site sums.

* **Compute** -- a roofline flop term ``flops / (p * peak)`` scaled by a
  blocksize-efficiency factor ``1 + HALF_NB/nb + IMB * nb/extent``, which
  gives the nb sweep an interior optimum; plus the pivot-chain,
  wire-decode and panel-launch terms.

* **Memory** -- a closed form per op: the live operand slabs sharded over
  the p ranks plus the largest buffer one collective stages, scaled with
  the area like the bytes; a candidate over the machine's device memory
  is pruned.

Everything runs on the CPU (``'auto'`` with an empty cache never touches
the card), is deterministic, and is memoized per probe geometry.  The
model is a RANKING device: the constants are the JAX package's
first-order per-backend defaults (override with ``machine=``).
"""
from __future__ import annotations

import dataclasses
import math

from .knobs import DEFAULT_CROSSOVER, TuneContext
from .policy import blocksize_policy, dtype_name

#: problems with sweep extent at or below this probe at their REAL
#: geometry (exact golden-comparable collective counts); larger ones probe
#: at a scaled geometry with at most _MAX_TRACE_STEPS blocked steps
TRACE_REAL_LIMIT = 96
_MAX_TRACE_STEPS = 6

#: blocksize-efficiency constants: HALF_NB is the panel width at which
#: matmul efficiency halves, IMB weights the serialized panel/tail
#: fraction nb/extent
HALF_NB = 512.0
IMB = 3.0

#: wire-byte scaling per ``comm_precision`` mode: bf16 is exactly half;
#: int8 blends the ~4x block-scaled gather family with the bf16-degraded
#: pairs and the packed scale rows
WIRE_FACTORS = {"bf16": 0.5, "int8": 0.3}

#: encode+decode vector passes over the LOGICAL payload per mode, priced
#: against ``MachineModel.decode_bw_bytes_per_s``
DECODE_PASSES = {"bf16": 2.0, "int8": 4.0}


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """First-order per-backend constants for the scoring terms."""
    name: str
    latency_s: float           # per collective round (dispatch + hop)
    bw_bytes_per_s: float      # per-rank collective bandwidth
    peak_flops: float          # per-rank fp32-class matmul peak
    #: vector-unit bandwidth pricing the quantize/dequantize passes
    decode_bw_bytes_per_s: float = 4.0e11
    #: per-rank device memory: candidates whose peak live bytes exceed it
    #: are PRUNED by the resolver, not merely penalized
    hbm_bytes: float = 16 * 2**30


#: the JAX package's own first-order 'gpu' and 'cpu' rows, verbatim
#: (the CPU tests hold the port's resolutions to the JAX package's on
#: both backends); the card's measured rates stand beside them in
#: PERF.md, not in here
MACHINES = {
    "gpu": MachineModel("gpu", latency_s=3e-6, bw_bytes_per_s=3.0e10,
                        peak_flops=2.0e13, hbm_bytes=80 * 2**30),
    "cpu": MachineModel("cpu", latency_s=5e-6, bw_bytes_per_s=1.0e10,
                        peak_flops=2.0e11, hbm_bytes=64 * 2**30),
}


def machine_for(backend: str) -> MachineModel:
    return MACHINES.get(str(backend).lower(), MACHINES["cpu"])


@dataclasses.dataclass
class CostBreakdown:
    """One scored candidate, with the terms ``explain`` prints."""
    config: dict
    compute_s: float
    latency_s: float
    bandwidth_s: float
    rounds: float              # extrapolated collective rounds
    comm_bytes: float          # extrapolated ring-model WIRE bytes/rank
    prim_counts: dict          # per-collective counts AT PROBE GEOMETRY
    detail: dict               # probe geometry / closed-form site notes
    pivot_s: float = 0.0       # pivot/reflector serial-chain latency
    decode_s: float = 0.0      # comm_precision encode/decode passes
    panel_impl_s: float = 0.0  # panel kernel-launch overhead
    peak_bytes: float = 0.0    # per-rank peak live bytes (closed form)
    pruned: bool = False       # peak_bytes > machine.hbm_bytes

    @property
    def total_s(self) -> float:
        return self.compute_s + self.latency_s + self.bandwidth_s \
            + self.pivot_s + self.decode_s + self.panel_impl_s

    def to_doc(self) -> dict:
        return {"config": dict(self.config),
                "total_s": self.total_s, "compute_s": self.compute_s,
                "latency_s": self.latency_s, "bandwidth_s": self.bandwidth_s,
                "pivot_s": self.pivot_s, "decode_s": self.decode_s,
                "panel_impl_s": self.panel_impl_s,
                "rounds": self.rounds, "comm_bytes": self.comm_bytes,
                "peak_bytes": self.peak_bytes, "pruned": self.pruned,
                "prim_counts": dict(self.prim_counts),
                "detail": dict(self.detail)}


# ---------------------------------------------------------------------
# flop counts (LAPACK working notes; square getrf = 2n^3/3 etc.)
# ---------------------------------------------------------------------

def op_flops(op: str, dims) -> float:
    if op == "cholesky":
        n = dims[0]
        return n ** 3 / 3
    if op == "lu":
        m, n = dims[0], dims[-1]
        k = min(m, n)
        return 2 * (m * n * k - (m + n) * k * k / 2 + k ** 3 / 3)
    if op == "qr":
        m, n = dims[0], dims[-1]
        k = min(m, n)
        return 2 * k * k * (max(m, n) - k / 3)
    if op == "trsm":
        m, n = dims[0], dims[-1]
        return float(m) * m * n
    if op == "herk":
        m, k = dims[0], dims[-1]
        return float(m) * m * k
    if op == "gemm":
        m, k, n = dims
        return 2.0 * m * k * n
    raise KeyError(f"no flop formula for op {op!r}")


def _compute_seconds(op: str, ctx: TuneContext, nb, machine: MachineModel,
                     nb_sensitive: bool = True) -> float:
    p = ctx.grid_size
    base = op_flops(op, ctx.dims) / (p * machine.peak_flops)
    if not nb_sensitive:
        return base
    ext = max(ctx.extent, 1)
    nb_r = blocksize_policy(nb, ctx.grain, ext)
    return base * (1.0 + HALF_NB / nb_r + IMB * nb_r / ext)


def _pivot_seconds(op: str, ctx: TuneContext, config: dict,
                   machine: MachineModel) -> float:
    """Pivot/reflector serial-chain latency, the term that differentiates
    the panel strategies: the classic lu/qr panels run one data-dependent
    step per column over the full panel height (an ``extent``-deep
    chain); the tree panels split it across the ``r`` grid rows and add
    ``ceil(log2 r)`` reduction rounds per panel."""
    if op not in ("lu", "qr"):
        return 0.0
    ext = max(ctx.extent, 1)
    unit = machine.latency_s
    panel = config.get("panel") or "classic"
    r = ctx.grid_shape[0]
    if panel == "classic" or r <= 1:
        return ext * unit
    nb_r = blocksize_policy(config.get("nb"), ctx.grain, ext)
    steps = max(1, math.ceil(ext / nb_r))
    return (ext / r) * unit + steps * math.ceil(math.log2(r)) * unit


#: slowdown of a panel kernel where it does not run natively: off the
#: card the kernel wrappers run their plain versions, so 'auto' must
#: never pick 'kernel' there (as the JAX package's interpret-mode Pallas
#: off-TPU).  Any value >> 1 yields the same winner.
INTERPRET_PENALTY = 50.0


def _panel_impl_seconds(op: str, ctx: TuneContext, config: dict,
                        machine: MachineModel) -> float:
    """Panel kernel-LAUNCH overhead, the term that differentiates the
    panel implementations: the plain panels run one op chain PER COLUMN
    of the sweep (``extent`` launch units); the hand-written kernel pays
    ONE launch per nb-panel, natively on the card ('gpu').  Elsewhere the
    kernel wrapper runs the plain version and is priced at
    :data:`INTERPRET_PENALTY` times the chain, so 'auto' keeps 'torch'
    there and the 'cpu' resolutions equal the JAX package's."""
    if op not in ("lu", "cholesky", "qr"):
        return 0.0
    ext = max(ctx.extent, 1)
    unit = machine.latency_s
    impl = config.get("panel_impl") or "torch"
    if impl != "kernel":
        return ext * unit
    if ctx.backend != "gpu":
        return ext * unit * INTERPRET_PENALTY
    nb_r = blocksize_policy(config.get("nb"), ctx.grain, ext)
    return max(1, math.ceil(ext / nb_r)) * unit


# ---------------------------------------------------------------------
# probed comm term (cholesky / lu / qr / trsm / herk)
# ---------------------------------------------------------------------

_TRACE_MEMO: dict = {}


def clear_trace_memo() -> None:
    _TRACE_MEMO.clear()


def _quant(v: float, grain: int, lo: int) -> int:
    from ..core.view import round_up
    return max(round_up(max(int(round(v)), 1), grain), lo)


def _geometry(ctx: TuneContext, nb, crossover, lookahead):
    """(probe dims, nb_t, xover_t, lat_scale, byte_scale) for the candidate.

    Small problems probe at their REAL geometry (exact counts, directly
    comparable to the golden comm plans).  Large ones keep the schedule
    shape but cap the step count: nb_t ~ 16 (grain-aligned), the crossover
    threshold maps to the same FRACTION of the sweep, latency extrapolates
    with the real step count and bytes with the real area.
    """
    grain = ctx.grain
    ext = max(ctx.extent, 1)
    nb_r = blocksize_policy(nb, grain, ext)
    steps_real = max(1, math.ceil(ext / nb_r))
    xo = crossover
    if xo is None:
        xo = DEFAULT_CROSSOVER if lookahead else 0
    if ext <= TRACE_REAL_LIMIT:
        dims_t = tuple(ctx.dims)
        return dims_t, nb_r, int(xo), 1.0, 1.0
    steps_t = min(steps_real, _MAX_TRACE_STEPS)
    nb_t = _quant(16, grain, grain)
    ext_t = nb_t * steps_t
    scale = ext_t / ext
    dims_t = tuple(ext_t if d == ext else _quant(d * scale, grain, nb_t)
                   for d in ctx.dims)
    frac = min(float(xo) / ext, 1.0) if xo else 0.0
    xo_t = nb_t * int(round(frac * steps_t))
    lat_scale = steps_real / steps_t
    area = 1.0
    for d_r, d_t in zip(ctx.dims, dims_t):
        area *= d_r / d_t
    return dims_t, nb_t, xo_t, lat_scale, area


#: live operand slabs per op for the memory term: the operand, the result
#: and the working copies a blocked step holds (the factorizations write
#: functionally: input, output, the trailing update and the panel's
#: buffers; QR adds its reflector block; the solves keep A and B, X and
#: half a working copy).  A ranking device, held within 2x of the JAX
#: package's liveness walk on the comm-plan goldens by the tests.
SLABS = {"cholesky": 4.0, "lu": 4.0, "qr": 5.0, "trsm": 2.5, "herk": 2.5}


def _operand_elems(op: str, dims) -> float:
    if op in ("cholesky",):
        return float(dims[0]) * dims[0]
    if op in ("lu", "qr"):
        return float(dims[0]) * dims[-1]
    if op == "trsm":
        m, n = dims[0], dims[-1]
        return float(m) * m + float(m) * n
    if op == "herk":
        m, k = dims[0], dims[-1]
        return float(m) * k + float(m) * m
    raise KeyError(f"no operand formula for op {op!r}")


def _staged_bytes(site) -> int:
    """Bytes of the buffer one collective leaves live on a rank: the whole
    gathered stack for an all_gather, the operand block otherwise."""
    nbytes = site.itemsize * math.prod(site.shape)
    return nbytes * site.axis_size if site.prim == "all_gather" else nbytes


def _probe_inputs(op: str, dims_t, grid, torch_dtype):
    """Seeded inputs of the probe call on the CPU grid (values do not
    steer the schedule; the HPD / triangular forms keep every driver on
    its normal path)."""
    import torch
    from ..core.dist import MC, MR
    from ..core.distmatrix import from_global
    gen = torch.Generator().manual_seed(0)

    def rnd(m, n):
        x = torch.randn((m, n), generator=gen, dtype=torch.float64)
        return x.to(torch_dtype)

    def dm(x):
        return from_global(x, MC, MR, grid)

    m, n = dims_t[0], dims_t[-1]
    if op == "cholesky":
        G = rnd(m, m)
        eye = torch.eye(m, dtype=torch_dtype)
        return (dm(G @ G.mH / m + m * eye),)
    if op == "trsm":
        eye = torch.eye(m, dtype=torch_dtype)
        return dm(torch.tril(rnd(m, m)) + m * eye), dm(rnd(m, n))
    return (dm(rnd(m, n)),)


def _trace_stats(op: str, dims_t, nb_t: int, la, xo_t, grid_shape, dtype,
                 panel: str = "classic", redist_path=None):
    """Probe ``op`` at the scaled geometry on a CPU grid of
    ``grid_shape`` and price its collectives; totals memoized."""
    key = (op, tuple(dims_t), nb_t, bool(la), int(xo_t), tuple(grid_shape),
           str(dtype), panel, redist_path)
    hit = _TRACE_MEMO.get(key)
    if hit is not None:
        return hit
    r, c = grid_shape
    sites = []
    if r * c > 1:          # every collective needs two ranks
        sites = _probe_sites(op, dims_t, nb_t, la, xo_t, grid_shape, dtype,
                             panel, redist_path)
    totals: dict = {}
    for s in sites:
        t = totals.setdefault(s.prim, {"count": 0, "bytes": 0})
        t["count"] += 1
        t["bytes"] += s.bytes
    p = max(r * c, 1)
    import torch
    z = getattr(torch, str(dtype)).itemsize
    peak = SLABS[op] * _operand_elems(op, dims_t) * z / p \
        + max((_staged_bytes(s) for s in sites), default=0)
    stats = {"totals": dict(sorted(totals.items())),
             "rounds": sum(1 for s in sites if s.axis_size > 1),
             "bytes": sum(t["bytes"] for t in totals.values()),
             "peak": peak}
    _TRACE_MEMO[key] = stats
    return stats


def _probe_sites(op, dims_t, nb_t, la, xo_t, grid_shape, dtype, panel,
                 redist_path) -> list:
    """Run the port's driver once at the probe geometry, unseen by the
    caller's counters, traces, observers, fault plan and metrics, and
    return the collectives a real grid would run for it."""
    import torch
    from ..core.grid import Grid
    from ..redist import engine as _engine
    grid = Grid(grid_shape[0], grid_shape[1], device="cpu")
    tdt = getattr(torch, str(dtype))
    args = _probe_inputs(op, dims_t, grid, tdt)
    with _engine.isolated_probe() as (trace, log):
        if op == "cholesky":
            from ..lapack.cholesky import cholesky
            cholesky(*args, nb=nb_t, lookahead=la, crossover=xo_t,
                     panel_impl="torch", redist_path=redist_path)
        elif op == "lu":
            from ..lapack.lu import lu
            lu(*args, nb=nb_t, lookahead=la, crossover=xo_t, panel=panel,
               panel_impl="torch", redist_path=redist_path)
        elif op == "qr":
            from ..lapack.qr import qr
            qr(*args, nb=nb_t, panel=panel, panel_impl="torch",
               redist_path=redist_path)
        elif op == "trsm":
            from ..blas.level3 import trsm
            trsm("L", "L", "N", *args, nb=nb_t, redist_path=redist_path)
        elif op == "herk":
            from ..blas.level3 import herk
            herk("L", *args, nb=nb_t, redist_path=redist_path)
        else:
            raise KeyError(f"no probe for op {op!r}")
        sites = [s for rec in trace for s in _engine.record_sites(rec)]
        sites += list(log)
    return sites


def _wire_terms(cbytes: float, comm_precision, machine: MachineModel):
    """(wire bytes, decode seconds) of the comm_precision term."""
    if not comm_precision:
        return cbytes, 0.0
    wire = cbytes * WIRE_FACTORS.get(comm_precision, 1.0)
    decode = DECODE_PASSES.get(comm_precision, 0.0) * cbytes \
        / machine.decode_bw_bytes_per_s
    return wire, decode


def _traced_cost(op: str, config: dict, ctx: TuneContext,
                 machine: MachineModel) -> CostBreakdown:
    la = config.get("lookahead", True)
    xo = config.get("crossover")
    nb = config.get("nb")
    panel = config.get("panel") or "classic"
    cpm = config.get("comm_precision")
    rp = config.get("redist_path")
    # panel_impl does not reach the probe: the panels are replicated-local
    # compute, so the comm schedule is identical under either
    # implementation, and one probe serves the whole panel_impl sweep
    dims_t, nb_t, xo_t, lat_scale, byte_scale = _geometry(ctx, nb, xo, la)
    stats = _trace_stats(op, dims_t, nb_t, la, xo_t, ctx.grid_shape,
                         ctx.dtype, panel, rp)
    rounds = stats["rounds"] * lat_scale
    cbytes = stats["bytes"] * byte_scale
    wire_bytes, decode_s = _wire_terms(cbytes, cpm, machine)
    peak = stats["peak"] * byte_scale
    return CostBreakdown(
        config=dict(config),
        compute_s=_compute_seconds(op, ctx, nb, machine),
        latency_s=machine.latency_s * rounds,
        bandwidth_s=wire_bytes / machine.bw_bytes_per_s,
        pivot_s=_pivot_seconds(op, ctx, config, machine),
        decode_s=decode_s,
        panel_impl_s=_panel_impl_seconds(op, ctx, config, machine),
        rounds=rounds, comm_bytes=wire_bytes,
        peak_bytes=peak, pruned=peak > machine.hbm_bytes,
        prim_counts={k: t["count"] for k, t in stats["totals"].items()},
        detail={"trace_dims": list(dims_t), "trace_nb": nb_t,
                "trace_crossover": xo_t, "lat_scale": round(lat_scale, 3),
                "byte_scale": round(byte_scale, 3), "panel": panel,
                "comm_precision": cpm, "redist_path": rp})


# ---------------------------------------------------------------------
# closed-form gemm comm plans (ring model per SUMMA schedule)
# ---------------------------------------------------------------------

def _gemm_sites(alg: str, m: int, k: int, n: int, r: int, c: int,
                nb, itemsize: int, grain_lcm: int, redist_path=None):
    """(site list, rounds, bytes) for one SUMMA schedule.

    Per-rank ring-model received bytes: all_gather of a local block of B
    bytes over S ranks costs B*(S-1); a psum costs 2*B*(S-1)/S.  Panel
    loops use the drivers' ``blocksize_policy`` grains.  With
    ``redist_path='direct'`` the operand moves are priced off the compiled
    :class:`~..redist.plan.RedistPlan` instead (one collective, or none
    when the plan is local)."""
    p = r * c
    z = itemsize
    sites = []

    def ag(tag, local_elems, s):
        if s > 1:
            sites.append((tag, "all_gather", local_elems * z * (s - 1)))

    def ps(tag, local_elems, s):
        if s > 1:
            sites.append((tag, "psum", 2 * local_elems * z * (s - 1) // s))

    def direct(tag, src_pair, dst_pair, gshape):
        from ..redist.plan import compile_plan
        plan = compile_plan(src_pair, dst_pair, gshape, (r, c))
        if plan is None or plan.kind == "local":
            return                          # zero collective rounds
        prim = "all_to_all" if plan.kind == "a2a" else "ppermute"
        sites.append((tag, prim, plan.wire_bytes(z)))

    use_direct = redist_path == "direct" and p > 1
    if use_direct:
        from ..core.dist import MC, MR, VC, STAR

    if alg == "C":
        kb = blocksize_policy(nb, grain_lcm, k)
        panels = max(1, math.ceil(k / kb))
        for _ in range(panels):
            if use_direct:
                direct("A1->[MC,*]", (MC, MR), (MC, STAR), (m, kb))
                direct("B1->[*,MR]", (MC, MR), (STAR, MR), (kb, n))
            else:
                ag("A1->[MC,*]", (m / r) * (kb / c), c)
                ag("B1->[*,MR]", (kb / r) * (n / c), r)
    elif alg == "A":
        jb = blocksize_policy(nb, c, n)
        panels = max(1, math.ceil(n / jb))
        for _ in range(panels):
            if use_direct:
                direct("B1->[MR,*]", (MC, MR), (MR, STAR), (k, jb))
            else:
                ag("B1->[MR,*]", (k / c) * (jb / r), r)  # gather over mc
            ps("D1 psum(mr)", (m / r) * jb, c)
            ag("D1->[MC,MR]", (m / r) * (jb / c), 1 if c == 1 else 2)
    elif alg == "B":
        ib = blocksize_policy(nb, r, m)
        panels = max(1, math.ceil(m / ib))
        for _ in range(panels):
            if use_direct:
                direct("A1^T->[MC,*]", (MR, MC), (MC, STAR), (k, ib))
            else:
                ag("A1^T->[MC,*]", (k / r) * (ib / c), c)
            ps("D1 psum(mc)", (ib / c) * n, r)
            ag("D1->[MC,MR]", (ib / r) * (n / c), 1 if r == 1 else 2)
    elif alg == "dot":
        if p > 1:
            if use_direct:
                direct("A->[*,VC]", (MC, MR), (STAR, VC), (m, k))
                direct("B->[VC,*]", (MC, MR), (VC, STAR), (k, n))
            else:
                ag("A->[*,VC]", m * (k / p), 2)          # cyclic re-land
                ag("B->[VC,*]", (k / p) * n, 2)
            ps("D psum(all)", m * n, p)
            ag("D filter", (m / r) * (n / c), 1)
    elif alg == "gspmd":
        ag("B->[MR,*]", (k / c) * (n / r), r)
        ps("D psum(mr)", (m / r) * n, c)
        ag("D->[MC,MR]", (m / r) * (n / c), 1 if c == 1 else 2)
    elif alg == "slice":
        # the slicing gemm: three one-shot plans priced off the same
        # compiled plans the executor runs, whatever redist_path says; no
        # hidden psum (k is unsharded on both sides of the contraction)
        if p > 1:
            from ..redist.plan import gemm_slice_plans
            for tag, plan in gemm_slice_plans(m, k, n, (r, c))[1]:
                if plan is None or plan.kind == "local":
                    continue                # degenerate relabeling leg
                prim = "all_to_all" if plan.kind == "a2a" else "ppermute"
                sites.append((tag, prim, plan.wire_bytes(z)))
    else:
        raise KeyError(f"unknown gemm alg {alg!r}")
    rounds = len(sites)
    total = int(sum(s[2] for s in sites))
    return sites, rounds, total


def _gemm_cost(config: dict, ctx: TuneContext, itemsize: int,
               machine: MachineModel) -> CostBreakdown:
    m, k, n = ctx.dims
    r, c = ctx.grid_shape
    alg = config["alg"]
    nb = config.get("nb")
    cpm = config.get("comm_precision")
    rp = config.get("redist_path")
    sites, rounds, cbytes = _gemm_sites(alg, m, k, n, r, c, nb, itemsize,
                                        ctx.grain, redist_path=rp)
    counts: dict = {}
    for _, prim, b in sites:
        if b > 0:
            counts[prim] = counts.get(prim, 0) + 1
    # the engine quantizes the redistribution collectives; the contraction
    # psums stay full precision (gemm's non-[*,*] pairs all degrade int8
    # -> bf16, so both modes price at bf16)
    ag_bytes = sum(b for _, p, b in sites
                   if p in ("all_gather", "all_to_all", "ppermute"))
    wire_ag, decode_s = _wire_terms(ag_bytes,
                                    "bf16" if cpm else None, machine)
    wire_bytes = (cbytes - ag_bytes) + wire_ag
    # closed-form peak: the three operands sharded over p, plus the
    # largest single gathered/reduced buffer a site stages
    p_dev = max(r * c, 1)
    base = (m * k + k * n + m * n) * itemsize / p_dev
    peak = base + max((b for _, _, b in sites), default=0)
    return CostBreakdown(
        config=dict(config),
        compute_s=_compute_seconds("gemm", ctx, nb, machine,
                                   nb_sensitive=alg in ("A", "B", "C")),
        latency_s=machine.latency_s * rounds,
        bandwidth_s=wire_bytes / machine.bw_bytes_per_s,
        decode_s=decode_s,
        rounds=rounds, comm_bytes=wire_bytes, prim_counts=counts,
        peak_bytes=peak, pruned=peak > machine.hbm_bytes,
        detail={"sites": [{"site": t, "prim": p, "bytes": b}
                          for t, p, b in sites],
                "comm_precision": cpm, "redist_path": rp})


# ---------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------

def score_config(op: str, config: dict, *, ctx: TuneContext, grid=None,
                 dtype=None, machine: MachineModel | None = None
                 ) -> CostBreakdown:
    """Score one candidate configuration of ``op`` at ``ctx``.

    Everything is read off ``ctx`` (its dims, dtype, grid shape and
    backend); ``grid`` and ``dtype`` are accepted for the JAX package's
    signature and may be omitted.  The probe of a traced op runs on a CPU
    grid of ``ctx.grid_shape`` whatever the request's device.
    """
    machine = machine or machine_for(ctx.backend)
    if op == "gemm":
        import torch
        name = ctx.dtype if dtype is None else dtype_name(dtype)
        return _gemm_cost(config, ctx, getattr(torch, name).itemsize, machine)
    return _traced_cost(op, config, ctx, machine)
