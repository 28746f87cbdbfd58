"""elemental_tpu_torch: the PyTorch/CUDA port of elemental_tpu.

Distributed dense linear algebra on a virtual r x c grid held on one
device (an NVIDIA H100 by default; ``Grid(device="cpu")`` for the CPU).
The stacked-storage layout of every ``DistMatrix`` is the JAX package's,
bit for bit.  Ported so far: the SPD solve (``cholesky``,
``cholesky_solve_after``, ``hpd_solve``), with the diagonal-block
factor/inverse as a hand-written CUDA kernel; the LU solve (``lu``,
``lu_solve``, ``lu_solve_after``, ``permute_rows``, ``permute_cols``),
with the partial-pivot panel as a hand-written cooperative CUDA kernel;
and QR least squares (``qr``, ``apply_q``, ``explicit_q``,
``least_squares``, ``lq``, ``apply_q_lq``, ``explicit_l``, ``rq``, with
``interior_view`` and ``identity``), with the Householder panel and its
block-reflector triangle as a hand-written cooperative CUDA kernel
(``kernels/csrc``); and the Hermitian eigensolvers (``herm_eig``,
``skew_herm_eig``, ``hermitian_svd``, ``herm_gen_def_eig``: Cholesky,
``two_sided_trsm``, ``hermitian_tridiag``, the Cuppen divide and conquer
``tridiag_eig`` and ``apply_q_herm_tridiag``), with SUMMA ``gemm``, the
level-2 BLAS and ``entry`` (the twin of ``__graft_entry__.py``).

The package imports ``torch`` and numpy only -- never ``jax`` and nothing
of ``elemental_tpu``.
"""
from .core.dist import Dist, MC, MD, MR, VC, VR, STAR, CIRC, LEGAL_PAIRS
from .core.grid import Grid, default_grid
from .core.environment import (blocksize, set_blocksize, push_blocksize,
                               pop_blocksize, blocksize_scope)
from .core.distmatrix import (DistMatrix, from_global, to_global, zeros,
                              from_storage, storage_numpy)
from .core.view import view, update_view
from .redist.engine import (redistribute, transpose_dist, panel_spread,
                           move_rows, permute_rows_storage)
from .redist.interior import interior_view, interior_update
from .blas import (make_trapezoidal, make_symmetric, index_dependent_map,
                   index_dependent_fill, gemv, ger, hemv, symv, her2, trmv,
                   trsv, gemm, trsm, trmm, two_sided_trsm, two_sided_trmm)
from .lapack import (cholesky, hpd_solve, cholesky_solve_after, lu,
                     lu_solve, lu_solve_after, permute_rows, permute_cols,
                     qr, apply_q, explicit_q, least_squares, lq, apply_q_lq,
                     explicit_l, rq, hermitian_tridiag, apply_q_herm_tridiag,
                     tridiag_eig, herm_eig, skew_herm_eig, herm_gen_def_eig,
                     hermitian_svd)
from .matrices import identity
from . import kernels, entry

__version__ = "0.1.0"
