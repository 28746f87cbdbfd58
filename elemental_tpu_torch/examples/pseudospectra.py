"""Pseudospectral portrait of the Grcar matrix (upstream
``examples/lapack_like/... Pseudospectra`` drivers).

The twin of the JAX package's ``examples/pseudospectra.py``: same flags,
defaults and report keys (see ``_common`` for ``--device`` / ``--ranks``).
"""
import sys
from pathlib import Path

import torch

if __package__ in (None, ""):           # run as a file: import the checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from elemental_tpu_torch.examples._common import (  # noqa: E402
    report, setup)


def main(argv=None) -> dict:
    el, args, grid = setup(argv)
    n = args.input("--n", "matrix size", 60)
    npts = args.input("--npts", "grid points per side", 12)
    args.process(report=True)

    A = el.matrices.grcar(n, grid=grid, dtype=torch.float64)
    Z, sigmin = el.pseudospectra(A, (-2.0, 3.0), (-3.5, 3.5), nx=npts,
                                 ny=npts)
    return report("pseudospectra", n=n, npts=npts,
                  sigmin_min=float(sigmin.min()),
                  sigmin_max=float(sigmin.max()))


if __name__ == "__main__":
    main()
