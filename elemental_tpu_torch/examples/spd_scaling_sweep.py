"""Grid-shape sweep of the HPD solve (the topology-variation smoke the
reference gets from its --r grid-height flag, SURVEY.md section 5).

The twin of the JAX package's ``examples/spd_scaling_sweep.py``: it
solves on every virtual grid r x (p / r) whose height r divides
``--ranks`` = p (see ``_common``), with the same flags, defaults and
report keys.
"""
import sys
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):           # run as a file: import the checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from elemental_tpu_torch.examples._common import (  # noqa: E402
    report, setup)


def main(argv=None) -> list:
    el, args, grid = setup(argv)
    n = args.input("--n", "matrix size", 160)
    args.process(report=True)

    rng = np.random.default_rng(0)
    G = rng.normal(size=(n, n))
    F = G @ G.T + n * np.eye(n)
    Fd = torch.as_tensor(F, device=grid.device)
    p = grid.size
    out = []
    for r in (h for h in range(1, p + 1) if p % h == 0):
        g = el.Grid(r, p // r, device=grid.device)
        A = el.from_global(F, el.MC, el.MR, grid=g)
        B = el.from_global(np.ones((n, 1)), el.MC, el.MR, grid=g)
        X = el.hpd_solve(A, B)
        resid = float(torch.linalg.norm(Fd @ el.to_global(X) - 1.0))
        out.append(report("spd_sweep", grid=f"{r}x{p // r}", resid=resid))
    return out


if __name__ == "__main__":
    main()
