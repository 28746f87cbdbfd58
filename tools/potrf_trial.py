#!/usr/bin/env python3
"""The quick chip check of ``potrf_inv`` alone: build it, hold it against
its plain version at the edges of both routes' blocking, and time it.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/potrf_trial.py

It builds ``csrc/potrf_inv.cu`` (timed), then, with ``chip_smoke.py``'s
own checks (:func:`chip_smoke.potrf_check`: both residuals and the
elementwise difference within ``RES_TOL`` / ``ELEM_TOL``), factors a
seeded SPD block of each width in :data:`WIDTHS` in float64 and
float32 and holds each result to the plain version's, and zero above
the diagonal; the float64 route at w = 300 under each cap of
:data:`CAPS`; a strided view against its contiguous copy (bit-equal);
and a block that is not positive definite (NaNs).  Then it times the
kernel, the plain version and one library call (``cholesky`` +
``solve_triangular``) at the main paths' blocks (:data:`TIMED`), with
the bound of ``chip_smoke.potrf_bound``.  One line per check and per
timed block; the last line counts the failures, and the exit code is 1
when any check failed.  A build or launch that fails raises.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: the edges of both routes' blocking: one column, below / at / past a
#: 16-column sub-block, a 32- and a 64-column diagonal block and a 64-row
#: tile, blocks that do not divide w, and the main paths' widths
WIDTHS = (1, 17, 31, 33, 63, 64, 65, 100, 129, 300, 512, 1000, 2048)
CAPS = (1, 7, 16, 32, 512)
TIMED = ((2048, "float64"), (2048, "float32"), (512, "float64"),
         (128, "float64"), (2048, "float64"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("potrf_trial: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from elemental_tpu_torch.kernels import (common, potrf_inv,
                                             potrf_inv_reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs._card_line(), flush=True)
    t = time.perf_counter()
    common.build(["potrf_inv"])
    print("build_s", time.perf_counter() - t, flush=True)
    fails = 0

    def check(label, fn):
        nonlocal fails
        try:
            print(label, json.dumps(fn()), flush=True)
        except AssertionError as e:
            fails += 1
            print("FAIL", label, e, flush=True)

    def factor(w, dt, bs=512):
        D, _ = cs._spd(w, dt, seed=w)
        L, Li = potrf_inv(D, bs=bs)
        torch.cuda.synchronize()
        out = cs.potrf_check(D, L, Li)
        if not (torch.equal(torch.triu(L, 1), torch.zeros_like(L))
                and torch.equal(torch.triu(Li, 1), torch.zeros_like(Li))):
            raise AssertionError("nonzero above the diagonal")
        return out

    for dt in (torch.float64, torch.float32):
        for w in WIDTHS:
            check(f"check {dt} {w}", lambda: factor(w, dt))
    for bs in CAPS:
        check(f"check float64 300 bs {bs}",
              lambda: factor(300, torch.float64, bs))

    def strided():
        big, _ = cs._spd(96, torch.float64, seed=3)
        junk = big + torch.triu(torch.ones_like(big), 1)
        L1, Li1 = potrf_inv(junk[:64, :64], bs=32)
        L2, Li2 = potrf_inv(big[:64, :64].contiguous(), bs=32)
        torch.cuda.synchronize()
        if not (torch.equal(L1, L2) and torch.equal(Li1, Li2)):
            raise AssertionError("a strided view differs from its copy")
        L, _ = potrf_inv(-torch.eye(8, dtype=torch.float64, device="cuda"))
        if not bool(torch.isnan(L).any()):
            raise AssertionError("no NaN from a block not positive definite")
        return {"strided_equal": True, "not_spd_nan": True}

    check("check strided view, not positive definite", strided)
    for w, name in TIMED:
        dt = getattr(torch, name)
        D, _ = cs._spd(w, dt, seed=w)
        eye = torch.eye(w, dtype=dt, device="cuda")
        reps = 20 if w <= 512 else 10
        row = {"w": w, "dtype": name,
               "kernel_ms": cs._time_ms(lambda: potrf_inv(D), reps),
               "plain_ms": cs._time_ms(lambda: potrf_inv_reference(D), reps),
               "library_ms": cs._time_ms(
                   lambda: torch.linalg.solve_triangular(
                       torch.linalg.cholesky(D), eye, upper=False), reps),
               "bound_ms": cs.potrf_bound(w, name, D.element_size())[0]}
        print("time", json.dumps(row), flush=True)
    print("fails", fails, flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
