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
``python -m elemental_tpu_torch.tune``); and observability (``obs``: the
span ``Tracer``, ``PhaseTimer`` and ``timer=`` on every driver, the
Perfetto export, the serving telemetry documents, ``python -m
elemental_tpu_torch.obs``), with the rest of the dense surface: the
matrix gallery (``matrices``), ``BlockMatrix``, ``DistMultiVec``, the
``*Ctrl`` structs, ``Timer`` / ``Args`` / ``ProgressLog``,
``remote_updates``, ``cholesky_pivoted`` and ``cholesky_mod``; and serving (``serve``:
``SolverService``'s admission, batched executor on captured CUDA graphs,
circuit breakers, certified escalation through the three kernels, the
async front, the fleet and the chaos matrix, with ``python -m
elemental_tpu_torch.serve``); and the solvers of the long tail: sparse
matrices (``sparse``: ``DistSparseMatrix`` in the JAX storage, a
deterministic segment-sum SpMV, ``cg``, ``cgls``, ``gmres``,
``sparse_direct_solve``), optimization (``optimization``: the Mehrotra
IPMs ``lp`` / ``qp`` / ``socp``, their affine forms, the sparse IPMs
with CG as captured CUDA graphs, equilibration, the proximal operators
and the models ``bp`` ... ``tv``; the dense IPMs factor through
``potrf_inv``, ``rpca`` through ``svd``), ``lattice`` (``lll``,
``shortest_vector``) and ``io`` (print, write, read, the ``'shards'``
checkpoints the JAX package reads, Matrix Market); and the static
analysis (``analysis``: the ``comm_plan/v1`` and ``memory_plan/v1``
documents of a recorded run, lint rules EL001-EL009, ``python -m
elemental_tpu_torch.analysis``).

The package imports ``torch``, numpy and scipy only -- never ``jax`` and
nothing of ``elemental_tpu``.
"""
from .core.dist import Dist, MC, MD, MR, VC, VR, STAR, CIRC, LEGAL_PAIRS
from .core.grid import Grid, default_grid, set_default_grid
from .core.environment import (blocksize, set_blocksize, push_blocksize,
                               pop_blocksize, blocksize_scope, Timer, Args,
                               ProgressLog)
from .core.ctrl import (SignCtrl, PolarCtrl, HermitianEigCtrl, SVDCtrl,
                        SchurCtrl, PseudospecCtrl, LDLPivotCtrl, QRCtrl,
                        LeastSquaresCtrl)
from .core.distmatrix import (DistMatrix, from_global, to_global, zeros,
                              remote_updates, from_storage, storage_numpy)
from .core.block import (BlockMatrix, block_from_global, block_from_array,
                         block_to_global, block_to_cyclic, block_from_cyclic,
                         as_elemental)
from .core.multivec import (DistMultiVec, mv_from_global, mv_to_global,
                            mv_zeros, mv_axpy, mv_scale, mv_dot, mv_nrm2,
                            mv_remote_updates, mv_to_distmatrix,
                            mv_from_distmatrix)
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
from .lapack import (cholesky, hpd_solve, cholesky_solve_after,
                     cholesky_pivoted, cholesky_mod)
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
from . import (blas, lapack, matrices, control, kernels, entry, obs,
               resilience, tune, serve, optimization, lattice, io, sparse,
               analysis)
from .resilience import (certified_solve, HealthMonitor, last_health_report,
                         FaultPlan, FaultSpec, fault_injection)
from .serve import SolverService, Deadline
from .optimization import (MehrotraCtrl, lp, qp, socp, soft_threshold, svt,
                           bp, lav, nnls, lasso, svm, rpca,
                           lp_affine, qp_affine, socp_affine,
                           ruiz_equil, geom_equil, symmetric_ruiz_equil,
                           lp_sparse, lav_sparse, bp_sparse,
                           cp, ds, en, nmf, sparse_inv_cov,
                           long_only_portfolio, tv)
from .lattice import lll, is_lll_reduced, shortest_vector
from .io import (print_matrix, write_matrix, read_matrix, checkpoint,
                 restore, write_matrix_market, read_matrix_market, display,
                 spy)
from .sparse import (Graph, DistGraph, SparseMatrix, DistSparseMatrix,
                     DistMap, sparse_from_coo, dist_sparse_from_coo,
                     cg, cgls, gmres, sparse_direct_solve)

__version__ = "0.1.0"
