"""BLAS: the level-1 zoo, level-2 matrix-vector products, SUMMA Gemm,
the rank-k and rank-2k updates, Hemm/Symm, blocked Trsm, QuasiTrsm,
MultiShiftTrsm, Trmm and the two-sided transforms."""
from . import level1
from .level1 import (axpy, scale, zero, fill, entrywise_map, hadamard,
                     conjugate, index_dependent_map, index_dependent_fill,
                     make_trapezoidal, shift_diagonal, make_symmetric,
                     get_diagonal, set_diagonal, update_diagonal,
                     diagonal_scale, diagonal_solve, frobenius_norm,
                     max_norm, one_norm, infinity_norm, entrywise_norm,
                     zero_norm, dot, dotu, nrm2, trace, transpose, adjoint,
                     real_part, imag_part, round_entries, swap, max_abs_loc,
                     min_abs_loc, max_loc, min_loc, scale_trapezoid,
                     axpy_trapezoid, safe_scale, get_submatrix,
                     set_submatrix)
from .level2 import gemv, ger, hemv, symv, her2, trmv, trsv
from .level3 import (gemm, herk, syrk, trrk, trsm, trr2k, her2k, syr2k,
                     hemm, symm, trmm, two_sided_trsm, two_sided_trmm,
                     multishift_trsm, quasi_trsm, local_rank_update)
