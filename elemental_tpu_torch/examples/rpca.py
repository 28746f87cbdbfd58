"""Robust PCA via ADMM + SVT (upstream ``examples/optimization/RPCA.cpp``).

The twin of the JAX package's ``examples/rpca.py``: same flags, defaults
and report keys (see ``_common`` for ``--device`` / ``--ranks``).
"""
import sys
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):           # run as a file: import the checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from elemental_tpu_torch.examples._common import (  # noqa: E402
    rel_norm, report, setup)


def main(argv=None) -> dict:
    el, args, grid = setup(argv)
    m = args.input("--m", "rows", 60)
    n = args.input("--n", "cols", 60)
    rk = args.input("--rank", "low rank", 3)
    args.process(report=True)

    rng = np.random.default_rng(0)
    Lo = rng.normal(size=(m, rk)) @ rng.normal(size=(rk, n))
    S0 = np.zeros((m, n))
    idx = rng.choice(m * n, (m * n) // 20, replace=False)
    S0.flat[idx] = rng.normal(size=idx.size) * 10
    M = el.from_global(Lo + S0, el.MC, el.MR, grid=grid)
    Lhat, Shat, info = el.rpca(M)
    Lod = torch.as_tensor(Lo, device=grid.device)
    err = rel_norm(el.to_global(Lhat) - Lod, Lod)
    return report("rpca", m=m, n=n, rank=rk, recovery_err=err,
                  iters=info.get("iters", -1))


if __name__ == "__main__":
    main()
