"""Factorizations (Cholesky, LU, QR), the tridiagonal reduction and the
Hermitian eigensolvers."""
from .cholesky import cholesky, hpd_solve, cholesky_solve_after
from .lu import lu, lu_solve, lu_solve_after, permute_rows, permute_cols
from .qr import (qr, apply_q, explicit_q, least_squares, lq, apply_q_lq,
                 explicit_l, rq)
from .condense import hermitian_tridiag, apply_q_herm_tridiag
from .tridiag_eig import tridiag_eig
from .spectral import (herm_eig, skew_herm_eig, herm_gen_def_eig,
                       hermitian_svd)
