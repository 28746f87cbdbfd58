"""SVD driver (upstream ``examples/lapack_like/SVD.cpp``).

The twin of the JAX package's ``examples/svd.py``: same flags, defaults
and report keys (see ``_common`` for ``--device`` / ``--ranks``).  The
reference singular values are ``torch.linalg.svdvals`` of the input on
the grid's device (the JAX example's ``np.linalg.svd``).
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
    m = args.input("--m", "rows", 250)
    n = args.input("--n", "cols", 120)
    args.process(report=True)

    rng = np.random.default_rng(0)
    F = rng.normal(size=(m, n))
    A = el.from_global(F, el.MC, el.MR, grid=grid)
    U, s, V = el.svd(A)
    Ug, Vg = el.to_global(U), el.to_global(V)
    Fd = torch.as_tensor(F, device=grid.device)
    rec = rel_norm((Ug * s[None, :]) @ Vg.T - Fd, Fd)
    sref = torch.linalg.svdvals(Fd)
    serr = float((torch.sort(s, descending=True).values - sref).abs().max()
                 / sref.max())
    return report("svd", m=m, n=n, reconstruct=rec, sv_err=serr)


if __name__ == "__main__":
    main()
