"""Redistribution microbench: src -> dst x geometry x path matrix (the twin
of the JAX package's ``perf/redist_bench.py``).

Times the SAME redistribution through the chained multi-hop engine
(``path='chain'``) and the one-shot compiled plan (``path='direct'``) on
a virtual grid, roofline-bracketed like :mod:`.ab_harness`.  Each row
prints as one ``redist_bench/v1`` JSON line:

    {"schema": "redist_bench/v1", "pair": "[MC,MR]->[MR,STAR]",
     "grid": "2x4", "n": 4096, "path": "direct", "plan": "a2a",
     "rounds": 1, "model_bytes": ..., "seconds": ..., "gbps": ...,
     "roof_tflops": [r_before, r_after], "match": true}

``rounds`` and ``model_bytes`` are what a real r x c grid would spend:
the ring-model per-device wire estimate the tuner's cost model and the
``'auto'`` path arbiter price (chain legs at all_gather / all_to_all /
ppermute ring cost from ``redist.engine.chain_cost``, the direct plan at
its one collective's slot volume from ``redist.plan.compile_plan``), the
JAX rows' numbers for the same pair, grid and n.  On one card a virtual
grid's redistribution is index copies on that card, not a network: the
``seconds``, the ``gbps`` (model bytes over measured seconds) and the
constants ``--record`` fits from them price those copies.  ``match``
checks the two paths against each other and the input bit for bit
before anything is timed.

Usage (``cuda:0`` unless ``--device cpu``; without a card it exits 2):

    python -m elemental_tpu_torch.perf.redist_bench
                        # the default pair matrix on 2x4 and 1x8 (the
                        #   grids of the JAX bench's 8 devices)
    python -m elemental_tpu_torch.perf.redist_bench --smoke
                        # 1x1 grid, n = 64, two pairs, tiny roofline
    python -m elemental_tpu_torch.perf.redist_bench --n 4096 --grid 2x2 \\
        --paths chain,direct
    python -m elemental_tpu_torch.perf.redist_bench \\
        --pairs "MC,MR->MR,STAR;VC,STAR->VR,STAR"
    python -m elemental_tpu_torch.perf.redist_bench --record
                        # also least-squares-fit alpha (s / round) and a
                        #   bandwidth from the rows and save them as
                        #   redist_constants/v1 in the port's tuning cache
                        #   ($ELEMENTAL_TPU_TORCH_TUNE_CACHE), which the
                        #   engine's 'auto' arbitration reads first
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

#: default src -> dst matrix: one representative of each plan regime --
#: the 3-hop gather chains gemm feeds on, a pure relabeling (ppermute), a
#: replication (fused all_gather chain vs one-shot a2a + concat), and a
#: transpose-style move
DEFAULT_PAIRS = (
    ("MC,MR", "MR,STAR"),
    ("MC,MR", "STAR,VC"),
    ("MC,MR", "STAR,STAR"),
    ("VC,STAR", "VR,STAR"),
    ("MC,MR", "MR,MC"),
    ("VC,STAR", "MC,STAR"),
)

SMOKE_PAIRS = DEFAULT_PAIRS[:2]

#: the rank count of the default grids (the JAX bench's 8 devices)
DEFAULT_RANKS = 8


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _min_t(fn, reps, device):
    ts = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _dist_pair(spec: str):
    import elemental_tpu_torch as el
    by_name = {d.value: d for d in
               (el.MC, el.MR, el.VC, el.VR, el.STAR, el.MD, el.CIRC)}
    try:
        c, r = (by_name[s.strip().upper()] for s in spec.split(","))
    except (KeyError, ValueError):
        raise SystemExit(f"bad dist pair {spec!r}; want e.g. 'MC,MR'")
    return (c, r)


def _parse_pairs(arg: str):
    out = []
    for leg in arg.split(";"):
        src, _, dst = leg.partition("->")
        if not dst:
            raise SystemExit(f"bad pair {leg!r}; want 'MC,MR->MR,STAR'")
        out.append((src.strip(), dst.strip()))
    return tuple(out)


def _label(pair) -> str:
    return f"[{pair[0].value},{pair[1].value}]"


def _roofline(n: int, device) -> float:
    """TFLOP/s of a full-float32 matmul at n (the chip-weather bracket of
    :mod:`.ab_harness`)."""
    from .ab_harness import Bench
    return Bench(device).roofline(n)


def _model_bytes(src, dst, gshape, grid_shape, itemsize, path):
    """Ring-model per-device wire estimate for one redistribution: the
    chain priced leg by leg, the direct path by its compiled plan."""
    from elemental_tpu_torch.redist.engine import chain_cost
    from elemental_tpu_torch.redist.plan import compile_plan
    if path == "direct":
        plan = compile_plan(src, dst, gshape, grid_shape)
        if plan is not None:
            return plan.rounds, plan.wire_bytes(itemsize), plan.kind
        path = "chain"                       # engine falls back identically
    rounds, nbytes = chain_cost(src, dst, gshape, grid_shape, itemsize)
    return rounds, nbytes, "chain"


def run_pair(grid, n, src, dst, paths, reps=3, check=True):
    """Time one src -> dst move under each path; returns a list of row
    dicts (no JSON printing -- the CLI and chip_smoke.py feed from
    here)."""
    import torch
    import elemental_tpu_torch as el

    host = np.arange(n * n, dtype=np.float32).reshape(n, n) % 1013 / 7.0
    A = el.from_global(host, src[0], src[1], grid)
    grid_shape = (grid.height, grid.width)
    itemsize = A.local.element_size()

    match = None
    if check:
        ref = torch.as_tensor(host, device=grid.device)
        outs = [el.to_global(el.redistribute(A, dst[0], dst[1], path=p))
                for p in paths]
        match = all(torch.equal(outs[0], o) for o in outs[1:]) \
            and torch.equal(outs[0], ref)
        del outs, ref

    rows = []
    for path in paths:
        el.redistribute(A, dst[0], dst[1], path=path)        # warm
        dt = max(_min_t(lambda p=path: el.redistribute(A, dst[0], dst[1],
                                                       path=p),
                        reps, grid.device), 1e-9)
        rounds, nbytes, plan_kind = _model_bytes(
            src, dst, (n, n), grid_shape, itemsize, path)
        rows.append({
            "schema": "redist_bench/v1",
            "pair": f"{_label(src)}->{_label(dst)}",
            "grid": f"{grid.height}x{grid.width}",
            "n": n,
            "path": path,
            "plan": plan_kind,
            "rounds": rounds,
            "model_bytes": nbytes,
            "seconds": dt,
            "gbps": nbytes / dt / 1e9,
            "match": match,
        })
    return rows


def p2p_gbps(grid, n=None, reps=3):
    """Chain-vs-direct GB/s of ONE representative move ([MC,MR] ->
    [MR,STAR]); ``{"pair", "n", "grid", "chain", "direct"}``.  On a 1x1
    grid both model-byte counts are zero, so both rates are 0.0."""
    if n is None:
        n = 256 if grid.size <= 8 else 4096
    rows = run_pair(grid, n, _dist_pair("MC,MR"), _dist_pair("MR,STAR"),
                    ("chain", "direct"), reps=reps, check=False)
    doc = {"pair": rows[0]["pair"], "n": n, "grid": rows[0]["grid"]}
    for row in rows:
        doc[row["path"]] = round(row["gbps"], 4)
    return doc


def fit_constants(rows):
    """Least-squares fit ``seconds = alpha * rounds + model_bytes / bw``
    over measured rows; returns ``(alpha_s, bw_bytes_per_s, nsamples)`` or
    None when the system is degenerate (e.g. a 1x1 grid where every row
    has zero rounds and zero bytes -- nothing to fit)."""
    samples = [(row["rounds"], row["model_bytes"], row["seconds"])
               for row in rows if row["rounds"] > 0 and row["seconds"] > 0]
    if len(samples) < 2:
        return None
    M = np.array([[float(r_), float(b_)] for r_, b_, _ in samples])
    t = np.array([s_ for _, _, s_ in samples])
    if np.linalg.matrix_rank(M) < 2:
        return None
    coef, *_ = np.linalg.lstsq(M, t, rcond=None)
    alpha = float(max(coef[0], 1e-9))        # s per collective round
    beta = float(max(coef[1], 1e-15))        # s per wire byte
    return alpha, 1.0 / beta, len(samples)


def record_constants(grid_shape, rows, backend):
    """Fit + persist ``redist_constants/v1`` for one grid and backend
    (``'gpu'`` / ``'cpu'``) in the port's tuning cache; returns the doc
    (with ``_path``) or None when the fit is degenerate."""
    from elemental_tpu_torch.tune.cache import (load_redist_constants,
                                                save_redist_constants)
    fit = fit_constants(rows)
    if fit is None:
        return None
    alpha, bw, nsamples = fit
    path = save_redist_constants(grid_shape, backend, alpha, bw,
                                 nsamples=nsamples)
    doc = dict(load_redist_constants(grid_shape, backend) or
               {"schema": "redist_constants/v1", "alpha_s": alpha,
                "bw_bytes_per_s": bw})
    doc["_path"] = path
    return doc


def _default_grids(p: int) -> list:
    """The JAX bench's grids of p devices: near-square, plus 1 x p when
    that differs."""
    from elemental_tpu_torch.entry import _near_square_height
    r = _near_square_height(p)
    return [(r, p // r)] if r == 1 else [(r, p // r), (1, p)]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    import torch
    import elemental_tpu_torch as el
    from elemental_tpu_torch.redist.engine import backend_of

    smoke = "--smoke" in argv
    record = "--record" in argv
    n = 64 if smoke else None
    grids = None
    paths = ("chain", "direct")
    pairs = SMOKE_PAIRS if smoke else DEFAULT_PAIRS
    reps = 3
    device = "cuda"
    it = iter(argv)
    for arg in it:
        if arg in ("--smoke", "--record"):
            continue
        elif arg == "--n":
            n = int(next(it))
        elif arg == "--grid":
            r, c = next(it).split("x")
            grids = [(int(r), int(c))]
        elif arg == "--paths":
            paths = tuple(p.strip() for p in next(it).split(","))
        elif arg == "--pairs":
            pairs = _parse_pairs(next(it))
        elif arg == "--reps":
            reps = int(next(it))
        elif arg == "--device":
            device = next(it)
        else:
            raise SystemExit(f"unknown flag {arg!r}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("redist_bench: no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 2
    on_card = dev.type == "cuda"
    if grids is None:
        grids = [(1, 1)] if smoke else _default_grids(DEFAULT_RANKS)
    if n is None:
        n = 4096 if on_card else 256
    roof_n = 8192 if on_card and not smoke else 256

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for gr, gc in grids:
            grid = el.Grid(gr, gc, device=dev)
            r0 = _roofline(roof_n, grid.device)
            rows = []
            for src_s, dst_s in pairs:
                rows += run_pair(grid, n, _dist_pair(src_s),
                                 _dist_pair(dst_s), paths, reps=reps)
            r1 = _roofline(roof_n, grid.device)
            for row in rows:
                row["roof_tflops"] = [round(r0, 3), round(r1, 3)]
                print(json.dumps(row))
                if row["match"] is False:
                    print(f"# MISMATCH {row['pair']} on {row['grid']}",
                          file=sys.stderr)
                    return 1
            if record:
                doc = record_constants((gr, gc), rows, backend_of(grid))
                if doc is None:
                    print(f"# record: degenerate fit on {gr}x{gc} "
                          f"(no multi-rank rows), nothing written",
                          file=sys.stderr)
                else:
                    print(json.dumps(doc))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
