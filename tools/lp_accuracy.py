#!/usr/bin/env python3
"""Attainable accuracy of the dense Mehrotra LP (``elemental_tpu_torch.lp``)
against its size.

For each m it builds the LP of ``chip_smoke.py`` phase 3n (a) -- m x 2m
normal A, a complementary primal-dual pair planted, so the optimum is
known -- and runs ``lp`` with the default ``MehrotraCtrl`` (tol 1e-8)
for at most ``--iters`` iterations, with the ``potrf_inv`` kernel and
with its plain version, and prints one JSON line per run: the
per-iteration (rel_gap, pfeas, dfeas, mu) from ``print_progress``, the
best pfeas reached, whether it converged, and the objective's error.

    python3 tools/lp_accuracy.py                 # on the card: 2048 4096 8192
    python3 tools/lp_accuracy.py --device cpu --m 128 256
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def instance(m: int, n: int, seed: int = 14):
    import numpy as np
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    basis = rng.choice(n, m, replace=False)
    x0 = np.zeros(n)
    x0[basis] = rng.uniform(0.5, 2.0, m)
    z0 = rng.uniform(0.5, 2.0, n)
    z0[basis] = 0.0
    y0 = rng.normal(size=m)
    c = A.T @ y0 + z0
    return A, A @ x0, c, float(c @ x0)


def run(et, m: int, impl: str, iters: int, device: str) -> dict:
    import torch
    from elemental_tpu_torch.kernels import potrf_inv, potrf_inv_reference
    chol = sys.modules["elemental_tpu_torch.lapack.cholesky"]
    chol._kernel_potrf_inv = potrf_inv if impl == "kernel" \
        else potrf_inv_reference
    A, b, c, opt = instance(m, 2 * m)
    g = et.Grid(device=device)
    args = [et.from_global(F.reshape(-1, 1) if F.ndim == 1 else F,
                           et.MC, et.MR, grid=g) for F in (A, b, c)]
    log = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(log):
        _, _, _, info = et.lp(*args, et.MehrotraCtrl(max_iters=iters,
                                                     print_progress=True))
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    chol._kernel_potrf_inv = potrf_inv
    pat = re.compile(r"gap=(\S+) pfeas=(\S+) dfeas=(\S+) mu=(\S+)")
    trace = [[float(v) for v in pat.search(line).groups()]
             for line in log.getvalue().splitlines() if pat.search(line)]
    return {"m": m, "n": 2 * m, "potrf_inv": impl, "wall_s": wall,
            "iters": info["iters"], "converged": info["converged"],
            "best_pfeas": min(r[1] for r in trace),
            "best_pfeas_iter": min(range(len(trace)),
                                   key=lambda i: trace[i][1]),
            "final": {k: info[k] for k in ("rel_gap", "pfeas", "dfeas",
                                           "mu")},
            "pobj_rel_err": abs(info["pobj"] - opt) / (1 + abs(opt)),
            "trace_gap_pfeas_dfeas_mu": trace}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, nargs="+", default=[2048, 4096, 8192])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    import torch
    import elemental_tpu_torch as et
    if a.device != "cpu":
        from elemental_tpu_torch.kernels import common
        torch.backends.cuda.matmul.allow_tf32 = False
        common.build(["potrf_inv"])
    for m in a.m:
        impls = ("kernel", "plain") if a.device != "cpu" and m == max(a.m) \
            else ("kernel",)
        for impl in impls:
            print(json.dumps(run(et, m, impl, a.iters, a.device)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
