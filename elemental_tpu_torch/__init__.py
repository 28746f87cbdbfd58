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
level-2 BLAS and ``entry`` (the twin of ``__graft_entry__.py``); and the
SVD (``svd``: the Chan route, QDWH ``polar`` + ``herm_eig``, the
Golub-Kahan route through ``bidiag``), the rest of the matrix functions
(``sign``, the inverses, ``pseudoinverse``, the square roots),
``herm_eig(approach='qdwh')``, ``hessenberg``, the rank-k updates
(``herk``, ``syrk``, ``trrk``) and the whole level-1 zoo; and the
symmetric-indefinite solver (``ldl``, ``symmetric_solve``,
``hermitian_solve``, ``inertia``), the Euclidean minimization solvers
(``ridge``, ``tikhonov``, ``lse``, ``glm``), the matrix properties
(``determinant`` ... ``two_norm``), the Schur decomposition (``schur``,
``triang_eig``, ``eig``, ``pseudospectra``), the control solvers
(``sylvester``, ``lyapunov``, ``riccati``), the rest of the level-3 BLAS
(``her2k``, ``syr2k``, ``trr2k``, ``hemm``, ``symm``, ``quasi_trsm``,
``multishift_trsm``), ``qr_col_piv`` and ``lu_full_pivot``; and the
communication-avoiding panels on the virtual grid (``lu(panel='calu')``,
tournament pivoting; ``qr(panel='tsqr')`` and ``tsqr``), with the
redistribution engine's call counters and trace records
(``redist_counts``, ``redist_trace``), its one-shot ``path='direct'``
plans, the quantized wire (``comm_precision='bf16'`` / ``'int8'``) and
``contract``; and the resilience layer (``resilience``: the health
monitors behind ``health=``, the checksum-guarded ``lu`` / ``cholesky``
/ ``qr`` behind ``abft=`` with per-panel rollback, seeded fault
injection, and ``certified_solve``'s escalation ladder), with the obs
metrics registry; and the tuner (``tune``: every ``'auto'`` knob of the
drivers and the engine resolves through the knob spaces, the persistent
tuning cache and an analytic cost model, with measurement on the card and
``python -m elemental_tpu_torch.tune``).

The package imports ``torch`` and numpy only -- never ``jax`` and nothing
of ``elemental_tpu``.
"""
from .core.dist import Dist, MC, MD, MR, VC, VR, STAR, CIRC, LEGAL_PAIRS
from .core.grid import Grid, default_grid
from .core.environment import (blocksize, set_blocksize, push_blocksize,
                               pop_blocksize, blocksize_scope)
from .core.distmatrix import (DistMatrix, from_global, to_global, zeros,
                              from_storage, storage_numpy)
from .core.view import view, update_view, pad_matrix
from .redist.engine import (redistribute, transpose_dist, panel_spread,
                           move_rows, permute_rows_storage, contract,
                           redist_counts, redist_trace)
from .redist.interior import interior_view, interior_update, vstack, hstack
from .blas import (gemm, herk, syrk, trrk, trsm, trr2k, her2k, syr2k,
                   hemm, symm, trmm, two_sided_trsm, two_sided_trmm,
                   multishift_trsm, quasi_trsm)
from .blas import gemv, ger, hemv, symv, her2, trmv, trsv
from .blas import (axpy, scale, fill, entrywise_map, hadamard,
                   index_dependent_map, index_dependent_fill,
                   make_trapezoidal, shift_diagonal, make_symmetric,
                   get_diagonal, set_diagonal, diagonal_scale,
                   diagonal_solve, frobenius_norm, max_norm, one_norm,
                   infinity_norm, dot, dotu, trace, transpose, adjoint,
                   real_part, imag_part, max_abs_loc, max_loc,
                   scale_trapezoid, axpy_trapezoid, safe_scale,
                   get_submatrix, set_submatrix)
from .lapack import cholesky, hpd_solve, cholesky_solve_after
from .lapack import (lu, lu_solve, lu_solve_after, permute_rows,
                     permute_cols, lu_full_pivot)
from .lapack import (qr, apply_q, explicit_q, least_squares, tsqr, lq,
                     apply_q_lq, explicit_l, qr_col_piv, rq)
from .lapack import ridge, tikhonov, lse, glm
from .lapack import (hermitian_tridiag, apply_q_herm_tridiag, hessenberg,
                     apply_q_hessenberg, bidiag, apply_p_bidiag)
from .lapack import (ldl, ldl_solve_after, symmetric_solve,
                     hermitian_solve, inertia)
from .lapack import (polar, sign, inverse, triangular_inverse, hpd_inverse,
                     pseudoinverse, square_root, hpd_square_root)
from .lapack import (herm_eig, skew_herm_eig, herm_gen_def_eig, hermitian_svd,
                     svd, tridiag_eig)
from .control import sylvester, lyapunov, riccati
from .lapack.schur import schur, triang_eig, eig, pseudospectra
from .lapack.props import (determinant, safe_determinant, hpd_determinant,
                           two_norm_estimate, condition, nuclear_norm,
                           schatten_norm, two_norm)
from .matrices import identity
from . import blas, lapack, control, kernels, entry, obs, resilience, tune

__version__ = "0.1.0"
