"""Level-1 helpers of the Cholesky slice.

PyTorch port of ``_global_indices`` and ``make_trapezoidal`` from
``elemental_tpu/blas/level1.py``.
"""
from __future__ import annotations

import torch

from ..core.distmatrix import DistMatrix


def _global_indices(A: DistMatrix):
    """(I, J) global index tensors matching the storage array layout
    (padding positions map to indices >= the extent)."""
    Sc, Sr = A.col_stride, A.row_stride
    lr, lc = A.local_rows, A.local_cols
    dev = A.local.device
    q = torch.arange(Sc, device=dev)[:, None]
    il = torch.arange(lr, device=dev)[None, :]
    I = (il * Sc + (q - A.calign) % Sc).reshape(-1)      # storage row -> global row
    q2 = torch.arange(Sr, device=dev)[:, None]
    jl = torch.arange(lc, device=dev)[None, :]
    J = (jl * Sr + (q2 - A.ralign) % Sr).reshape(-1)
    return I, J


def make_trapezoidal(A: DistMatrix, uplo: str, offset: int = 0) -> DistMatrix:
    """Zero outside the lower/upper trapezoid (MakeTrapezoidal)."""
    I, J = _global_indices(A)
    if uplo.upper().startswith("L"):
        keep = J[None, :] <= I[:, None] + offset
    else:
        keep = J[None, :] >= I[:, None] + offset
    return A.with_local(torch.where(keep, A.local, 0))
