"""BLAS of the Cholesky slice: trapezoid masking and blocked Trsm."""
from .level1 import make_trapezoidal
from .level3 import trsm, local_rank_update
