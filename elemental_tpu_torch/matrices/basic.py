"""The identity matrix.

PyTorch port of ``identity`` from ``elemental_tpu/matrices/basic.py``:
a zero [MC,MR] matrix plus one on the global diagonal, so the stacked
storage (padding zero) is bit-equal to the JAX package's.
"""
from __future__ import annotations

import torch

from ..blas.level1 import _global_indices
from ..core.dist import MC, MR
from ..core.distmatrix import DistMatrix, zeros
from ..core.grid import Grid, default_grid


def identity(m: int, n: int | None = None, grid: Grid | None = None,
             dtype=torch.float32) -> DistMatrix:
    """The (m, n) identity ([MC,MR]; ``n`` defaults to ``m``)."""
    A = zeros(m, n or m, MC, MR, grid or default_grid(), dtype=dtype)
    I, J = _global_indices(A)
    on = (J[None, :] == I[:, None]) & (I[:, None] < m) \
        & (J[None, :] < (n or m))
    return A.with_local(A.local + on.to(dtype))
