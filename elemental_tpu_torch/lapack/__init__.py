"""Factorizations of the Cholesky slice."""
from .cholesky import cholesky, hpd_solve, cholesky_solve_after
