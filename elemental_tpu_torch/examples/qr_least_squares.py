"""QR + least squares (upstream ``examples/lapack_like/QR.cpp``).

The twin of the JAX package's ``examples/qr_least_squares.py``: same
flags, defaults and report keys (see ``_common`` for ``--device`` /
``--ranks``).  Q is the explicit m x m unitary, as in JAX.
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
    m = args.input("--m", "rows", 400)
    n = args.input("--n", "cols", 120)
    args.process(report=True)

    rng = np.random.default_rng(0)
    F = rng.normal(size=(m, n))
    A = el.from_global(F, el.MC, el.MR, grid=grid)
    Ap, tau = el.qr(A)
    Qg = el.to_global(el.explicit_q(Ap, tau))
    del Ap, tau
    G = Qg.T @ Qg
    del Qg
    G.diagonal().sub_(1.0)
    orth = float(torch.linalg.norm(G))
    del G
    b = rng.normal(size=(m, 1))
    X = el.least_squares(A, el.from_global(b, el.MC, el.MR, grid=grid))
    xref = torch.linalg.lstsq(torch.as_tensor(F, device=grid.device),
                              torch.as_tensor(b, device=grid.device)).solution
    err = rel_norm(el.to_global(X) - xref, xref)
    return report("qr", m=m, n=n, orth=orth, lstsq_err=err)


if __name__ == "__main__":
    main()
