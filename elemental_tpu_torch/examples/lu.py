"""LU with partial pivoting (upstream ``examples/lapack_like/LU.cpp``).

The twin of the JAX package's ``examples/lu.py``: same flags, defaults
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
    n = args.input("--n", "matrix size", 300)
    args.process(report=True)

    rng = np.random.default_rng(0)
    F = rng.normal(size=(n, n))
    A = el.from_global(F, el.MC, el.MR, grid=grid)
    LU, perm = el.lu(A)
    lug = el.to_global(LU)
    del LU
    Fd = torch.as_tensor(F, device=grid.device)
    LUp = torch.tril(lug, -1) + torch.eye(n, dtype=lug.dtype, device=lug.device)
    LUp = LUp @ torch.triu(lug)
    del lug
    resid = rel_norm(LUp - Fd[perm], Fd)
    del LUp
    X = el.lu_solve(A, el.from_global(np.ones((n, 2)), el.MC, el.MR,
                                      grid=grid))
    sres = float(torch.linalg.norm(Fd @ el.to_global(X) - 1.0))
    return report("lu", n=n, factor_resid=resid, solve_resid=sres)


if __name__ == "__main__":
    main()
