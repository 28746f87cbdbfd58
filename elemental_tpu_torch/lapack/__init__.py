"""Factorizations (Cholesky, LU, QR), the condense reductions, the matrix
functions (QDWH polar, sign, inverses, square roots), the Hermitian
eigensolvers and the SVD."""
from .cholesky import cholesky, hpd_solve, cholesky_solve_after
from .lu import lu, lu_solve, lu_solve_after, permute_rows, permute_cols
from .qr import (qr, apply_q, explicit_q, least_squares, lq, apply_q_lq,
                 explicit_l, rq)
from .condense import (hermitian_tridiag, apply_q_herm_tridiag, hessenberg,
                       apply_q_hessenberg, bidiag, apply_p_bidiag)
from .funcs import (polar, sign, inverse, triangular_inverse, hpd_inverse,
                    pseudoinverse, square_root, hpd_square_root)
from .tridiag_eig import tridiag_eig
from .spectral import (herm_eig, skew_herm_eig, herm_gen_def_eig,
                       hermitian_svd, svd)
