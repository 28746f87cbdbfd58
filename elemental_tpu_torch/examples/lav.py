"""Sparse least-absolute-value regression (upstream
``examples/optimization/LAV.cpp``).

The twin of the JAX package's ``examples/lav.py``: same flags, defaults
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
    m = args.input("--m", "rows", 400)
    n = args.input("--n", "cols", 60)
    nnz = args.input("--nnz", "nonzeros", 3000)
    args.process(report=True)

    import scipy.sparse as sp
    from elemental_tpu_torch.core.multivec import (mv_from_global,
                                                   mv_to_global)
    from elemental_tpu_torch.sparse.core import dist_sparse_from_coo
    rng = np.random.default_rng(0)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz)
    As = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    xt = rng.normal(size=n)
    b = As @ xt
    out = rng.choice(m, m // 10, replace=False)
    b[out] += rng.normal(size=out.size) * 20            # gross outliers
    A = dist_sparse_from_coo(rows, cols, vals, m, n, grid=grid,
                             dtype=np.float64)
    x, info = el.lav_sparse(A, mv_from_global(b.reshape(-1, 1), grid=grid),
                            el.MehrotraCtrl(tol=1e-6, max_iters=60))
    xg = mv_to_global(x).cpu().numpy().ravel()
    return report("lav", m=m, n=n, converged=info["converged"],
                  rel_gap=info["rel_gap"],
                  recovery_err=float(np.linalg.norm(xg - xt)
                                     / np.linalg.norm(xt)))


if __name__ == "__main__":
    main()
