"""HPD factor + solve driver (upstream ``examples/lapack_like/Cholesky.cpp``).

The twin of the JAX package's ``examples/cholesky.py``: same flags,
defaults and report keys (see ``_common`` for ``--device`` / ``--ranks``).
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
    nrhs = args.input("--nrhs", "right-hand sides", 4)
    args.process(report=True)

    rng = np.random.default_rng(0)
    A = el.matrices.hermitian_uniform_spectrum(n, 1.0, 10.0, grid=grid)
    F = el.to_global(A)
    L = el.cholesky(A)
    Lg = el.to_global(L)
    resid = rel_norm(F - Lg @ Lg.T, F)
    del Lg
    B = el.from_global(rng.normal(size=(n, nrhs)), el.MC, el.MR, grid=grid)
    X = el.hpd_solve(A, B)
    sres = rel_norm(F @ el.to_global(X) - el.to_global(B), F)
    return report("cholesky", n=n, factor_resid=resid, solve_resid=sres)


if __name__ == "__main__":
    main()
