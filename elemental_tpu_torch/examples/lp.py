"""Dense Mehrotra LP (upstream ``examples/optimization/LP.cpp``-style).

The twin of the JAX package's ``examples/lp.py``: same flags, defaults
and report keys (see ``_common`` for ``--device`` / ``--ranks``).
"""
import sys
from pathlib import Path

import numpy as np

if __package__ in (None, ""):           # run as a file: import the checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from elemental_tpu_torch.examples._common import (  # noqa: E402
    report, setup)


def main(argv=None) -> dict:
    el, args, grid = setup(argv)
    m = args.input("--m", "constraints", 20)
    n = args.input("--n", "variables", 50)
    args.process(report=True)

    rng = np.random.default_rng(0)
    A = rng.normal(size=(m, n))
    x0 = rng.uniform(0.5, 1.5, n)
    b = A @ x0
    c = A.T @ rng.normal(size=m) + rng.uniform(0.1, 2.0, n)

    def g(F):
        return el.from_global(F, el.MC, el.MR, grid=grid)

    x, y, z, info = el.lp(g(A), g(b.reshape(-1, 1)), g(c.reshape(-1, 1)))
    return report("lp", m=m, n=n, converged=info["converged"],
                  rel_gap=info["rel_gap"], iters=info["iters"])


if __name__ == "__main__":
    main()
