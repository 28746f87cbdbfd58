"""Factorizations of the Cholesky and LU slices."""
from .cholesky import cholesky, hpd_solve, cholesky_solve_after
from .lu import lu, lu_solve, lu_solve_after, permute_rows, permute_cols
