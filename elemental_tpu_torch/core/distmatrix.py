"""DistMatrix: a distributed matrix held as one stacked-storage tensor.

PyTorch port of ``elemental_tpu/core/distmatrix.py`` (the reference's
``DistMatrix<T,ColDist,RowDist>``, Elemental ``include/El/core/DistMatrix/``).
One dataclass holds one tensor, ``local``: the "stacked storage" array of
shape ``(S_col*local_rows, S_row*local_cols)``, whose tile (q_col, q_row)
is rank (q_col, q_row)'s local cyclic block, padded to the uniform extent
``ceil(extent/stride)`` with ZEROS.  The layout is the JAX package's, bit
for bit, so storage moves between the two packages as a plain array
(:func:`from_storage` / :func:`storage_numpy`).

The storage array is an index permutation of the mathematical matrix,
never interpreted directly; use :func:`to_global` / :func:`from_global`
at the API edge.  Library code never writes into a ``local`` tensor it was
handed: results are new tensors, and in-place updates happen only on the
library's own copies.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import indexing as ix
from .dist import (Dist, LEGAL_PAIRS, stride as dist_stride, storage_slots,
                   md_slot_of_global)
from .grid import Grid, default_grid


@dataclasses.dataclass(frozen=True)
class DistMatrix:
    local: Any                    # torch.Tensor: stacked storage
    gshape: tuple                 # true (unpadded) global shape (m, n)
    cdist: Dist
    rdist: Dist
    calign: int
    ralign: int
    grid: Grid

    # ---- static layout math -----------------------------------------
    @property
    def col_stride(self) -> int:
        return dist_stride(self.cdist, self.grid.height, self.grid.width)

    @property
    def row_stride(self) -> int:
        return dist_stride(self.rdist, self.grid.height, self.grid.width)

    @property
    def local_rows(self) -> int:
        return ix.max_local_length(self.gshape[0], self.col_stride)

    @property
    def local_cols(self) -> int:
        return ix.max_local_length(self.gshape[1], self.row_stride)

    @property
    def dist(self) -> tuple:
        return (self.cdist, self.rdist)

    @property
    def dtype(self):
        return self.local.dtype

    # ---- functional update helpers ----------------------------------
    def with_local(self, local) -> "DistMatrix":
        return dataclasses.replace(self, local=local)

    def __repr__(self):
        return (
            f"DistMatrix[{self.cdist.value},{self.rdist.value}]"
            f"(gshape={self.gshape}, grid={self.grid}, dtype={self.local.dtype})"
        )


def _check_pair(cdist: Dist, rdist: Dist):
    if (cdist, rdist) not in LEGAL_PAIRS:
        raise ValueError(f"illegal distribution pair [{cdist},{rdist}]")


# ---------------------------------------------------------------------
# Global <-> storage bridges (the API edge)
# ---------------------------------------------------------------------

def _storage_index(extent: int, stride: int, align: int) -> np.ndarray:
    """Flat index map: storage position (q*l + iLoc) <- global index.

    Returns an int64 array of length stride*l whose entries are global
    indices (>= extent for padding positions).
    """
    l = ix.max_local_length(extent, stride)
    q = np.arange(stride).reshape(stride, 1)
    il = np.arange(l).reshape(1, l)
    return (il * stride + (q - align) % stride).reshape(-1)


def _storage_index_dim(extent: int, d: Dist, r: int, c: int,
                       align: int) -> np.ndarray:
    """Storage-position -> global-index map for one dimension, MD-aware."""
    if d is Dist.MD:
        if align:
            raise ValueError("MD alignments are unsupported")
        L = dist_stride(d, r, c)
        l = ix.max_local_length(extent, L)
        inv = np.full(r * c * l, extent, np.int64)        # padding sentinel
        inv[md_slot_of_global(r, c, extent)] = np.arange(extent)
        return inv
    return _storage_index(extent, dist_stride(d, r, c), align)


def _global_index_dim(extent: int, d: Dist, r: int, c: int, align: int,
                      lloc: int) -> np.ndarray:
    """Global-index -> storage-position map for one dimension (the inverse
    of :func:`_storage_index_dim` on the non-padding positions)."""
    if d is Dist.MD:
        return md_slot_of_global(r, c, extent)
    S = dist_stride(d, r, c)
    i = np.arange(extent)
    return ((i + align) % S) * lloc + i // S


def _take_fill(x: torch.Tensor, dim: int, idx: np.ndarray,
               extent: int) -> torch.Tensor:
    """``x.index_select(dim, idx)`` with positions ``idx >= extent`` set to
    zero (the padding-is-zero invariant).  An identity map returns ``x``
    itself."""
    if idx.size == extent and np.array_equal(idx, np.arange(extent)):
        return x
    shape = list(x.shape)
    shape[dim] = idx.size
    if extent == 0:
        return x.new_zeros(shape)
    it = torch.as_tensor(np.minimum(idx, extent - 1), device=x.device)
    out = x.index_select(dim, it)
    pad = idx >= extent
    if pad.any():
        keep = torch.as_tensor(~pad, device=x.device)
        keep = keep.reshape([-1 if a == dim else 1 for a in range(x.dim())])
        out = torch.where(keep, out, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))
    return out


def _as_tensor(arr, device) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    return torch.as_tensor(np.asarray(arr), device=device)


def from_global(arr, cdist: Dist, rdist: Dist, grid: Grid | None = None,
                calign: int = 0, ralign: int = 0) -> DistMatrix:
    """Build a DistMatrix (stacked-storage form) from a global array (numpy
    or tensor).  The result owns a fresh tensor on ``grid.device``."""
    _check_pair(cdist, rdist)
    grid = grid or default_grid()
    x = _as_tensor(arr, grid.device)
    if x.dim() != 2:
        raise ValueError(f"from_global needs a 2-D array, got {tuple(x.shape)}")
    m, n = x.shape
    if cdist is Dist.CIRC:
        return DistMatrix(x.clone(), (m, n), cdist, rdist, 0, 0, grid)
    r, c = grid.height, grid.width
    stor = _take_fill(x, 0, _storage_index_dim(m, cdist, r, c, calign), m)
    stor = _take_fill(stor, 1, _storage_index_dim(n, rdist, r, c, ralign), n)
    if stor is x:
        stor = stor.clone()
    return DistMatrix(stor, (m, n), cdist, rdist, calign, ralign, grid)


def to_global(A: DistMatrix) -> torch.Tensor:
    """Recover the mathematical (m, n) matrix from stacked storage, as a
    fresh tensor."""
    m, n = A.gshape
    if A.cdist is Dist.CIRC:
        return A.local.clone()
    r, c = A.grid.height, A.grid.width
    ri = _global_index_dim(m, A.cdist, r, c, A.calign, A.local_rows)
    cj = _global_index_dim(n, A.rdist, r, c, A.ralign, A.local_cols)
    out = A.local
    if np.array_equal(ri, np.arange(out.shape[0])) \
            and np.array_equal(cj, np.arange(out.shape[1])):
        return out.clone()
    out = out.index_select(0, torch.as_tensor(ri, device=out.device))
    return out.index_select(1, torch.as_tensor(cj, device=out.device))


def zeros(m: int, n: int, cdist: Dist = Dist.MC, rdist: Dist = Dist.MR,
          grid: Grid | None = None, dtype=torch.float32,
          calign: int = 0, ralign: int = 0) -> DistMatrix:
    _check_pair(cdist, rdist)
    grid = grid or default_grid()
    if cdist is Dist.CIRC:
        return DistMatrix(torch.zeros((m, n), dtype=dtype, device=grid.device),
                          (m, n), cdist, rdist, 0, 0, grid)
    r, c = grid.height, grid.width
    qc, qr_ = storage_slots(cdist, r, c), storage_slots(rdist, r, c)
    sc, sr = dist_stride(cdist, r, c), dist_stride(rdist, r, c)
    lr, lc = ix.max_local_length(m, sc), ix.max_local_length(n, sr)
    stor = torch.zeros((qc * lr, qr_ * lc), dtype=dtype, device=grid.device)
    return DistMatrix(stor, (m, n), cdist, rdist, calign, ralign, grid)


# ---------------------------------------------------------------------
# Storage carried across packages ("weights across")
# ---------------------------------------------------------------------

def _storage_shape(gshape, cdist: Dist, rdist: Dist, grid: Grid) -> tuple:
    """Shape of the stacked storage of a (cdist, rdist) matrix."""
    m, n = gshape
    if cdist is Dist.CIRC:
        return (m, n)
    r, c = grid.height, grid.width
    return (storage_slots(cdist, r, c)
            * ix.max_local_length(m, dist_stride(cdist, r, c)),
            storage_slots(rdist, r, c)
            * ix.max_local_length(n, dist_stride(rdist, r, c)))


def from_storage(local_np, gshape, cdist: Dist, rdist: Dist,
                 calign: int = 0, ralign: int = 0,
                 grid: Grid | None = None) -> DistMatrix:
    """Wrap a stacked-storage array (e.g. ``np.asarray(jax_A.local)``) as a
    DistMatrix without any index math: the layouts are identical."""
    _check_pair(cdist, rdist)
    grid = grid or default_grid()
    gshape = tuple(int(v) for v in gshape)
    want = _storage_shape(gshape, cdist, rdist, grid)
    arr = np.array(local_np)                  # owned copy
    if arr.shape != want:
        raise ValueError(f"storage shape {arr.shape} != {want} for "
                         f"[{cdist},{rdist}] {gshape} on {grid}")
    return DistMatrix(torch.as_tensor(arr, device=grid.device), gshape,
                      cdist, rdist, calign, ralign, grid)


def storage_numpy(A: DistMatrix) -> np.ndarray:
    """The stacked storage of ``A`` as a host numpy array (the inverse of
    :func:`from_storage`)."""
    return A.local.detach().resolve_conj().cpu().numpy().copy()
