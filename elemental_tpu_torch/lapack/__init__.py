"""Factorizations (Cholesky with its pivoted and rank-k-modified
variants, LU with partial and complete pivoting, QR
with and without column pivoting, Bunch-Kaufman LDL), the Euclidean
minimization solvers, the condense reductions, the matrix functions
(QDWH polar, sign, inverses, square roots), the Hermitian eigensolvers,
the SVD, the Schur decomposition and the matrix properties."""
from .cholesky import (cholesky, hpd_solve, cholesky_solve_after,
                       cholesky_pivoted, cholesky_mod)
from .lu import (lu, lu_solve, lu_solve_after, permute_rows, permute_cols,
                 lu_full_pivot)
from .qr import (qr, apply_q, explicit_q, least_squares, tsqr, lq,
                 apply_q_lq, explicit_l, qr_col_piv, rq)
from .euclidean_min import ridge, tikhonov, lse, glm
from .condense import (hermitian_tridiag, apply_q_herm_tridiag, hessenberg,
                       apply_q_hessenberg, bidiag, apply_p_bidiag)
from .ldl import (ldl, ldl_solve_after, symmetric_solve, hermitian_solve,
                  inertia)
from .funcs import (polar, sign, inverse, triangular_inverse, hpd_inverse,
                    pseudoinverse, square_root, hpd_square_root)
from .tridiag_eig import tridiag_eig
from .spectral import (herm_eig, skew_herm_eig, herm_gen_def_eig,
                       hermitian_svd, svd)
from .schur import schur, triang_eig, eig, pseudospectra
from .props import (determinant, safe_determinant, hpd_determinant,
                    two_norm_estimate, condition, inertia as matrix_inertia,
                    nuclear_norm, schatten_norm, two_norm)
