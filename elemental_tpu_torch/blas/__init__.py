"""BLAS: level-1 index maps and masks, level-2 matrix-vector products,
SUMMA Gemm, blocked Trsm, Trmm and the two-sided transforms."""
from .level1 import (make_trapezoidal, make_symmetric, index_dependent_map,
                     index_dependent_fill)
from .level2 import gemv, ger, hemv, symv, her2, trmv, trsv
from .level3 import (gemm, trsm, trmm, two_sided_trsm, two_sided_trmm,
                     local_rank_update)
