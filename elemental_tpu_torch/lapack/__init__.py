"""Factorizations of the Cholesky, LU and QR slices."""
from .cholesky import cholesky, hpd_solve, cholesky_solve_after
from .lu import lu, lu_solve, lu_solve_after, permute_rows, permute_cols
from .qr import (qr, apply_q, explicit_q, least_squares, lq, apply_q_lq,
                 explicit_l, rq)
