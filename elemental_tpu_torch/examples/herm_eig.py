"""Hermitian eigensolver (upstream ``examples/lapack_like/HermitianEig.cpp``).

The twin of the JAX package's ``examples/herm_eig.py``: same flags,
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
    n = args.input("--n", "matrix size", 200)
    args.process(report=True)

    rng = np.random.default_rng(0)
    G = rng.normal(size=(n, n))
    F = (G + G.T) / 2
    A = el.from_global(F, el.MC, el.MR, grid=grid)
    w, Z = el.herm_eig(A)
    Zg = el.to_global(Z)
    Fd = torch.as_tensor(F, device=grid.device)
    resid = rel_norm(Fd @ Zg - Zg * w[None, :], Fd)
    Gz = Zg.T @ Zg
    Gz.diagonal().sub_(1.0)
    orth = float(torch.linalg.norm(Gz))
    return report("herm_eig", n=n, resid=resid, orth=orth,
                  w_min=float(w[0]), w_max=float(w[-1]))


if __name__ == "__main__":
    main()
