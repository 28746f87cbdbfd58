"""DistMultiVec: tall-skinny dense matrix with contiguous row-block layout.

PyTorch port of ``elemental_tpu/core/multivec.py`` (the reference's
``El::DistMultiVec<T>``, ``include/El/core/DistMultiVec/``): rows
distributed in CONTIGUOUS blocks (not cyclic) over all p ranks; the
operand type of the sparse solvers and IPMs, with queued
``RemoteUpdate`` batched writes.

The storage is the global array zero-padded to ``p * ceil(m/p)`` rows,
the JAX package's layout bit for bit: rank d owns padded-global rows
[d*blk, (d+1)*blk).  Because blocks are contiguous and uniform, storage
row index == global row index (padding lives at the tail), so host
bridges are slices, elementwise ops and reductions run directly on the
storage (padding zero), and batched remote updates are one scatter-add.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .grid import Grid, default_grid


def _blk(m: int, p: int) -> int:
    return -(-max(m, 1) // p)


@dataclasses.dataclass(frozen=True)
class DistMultiVec:
    local: Any        # (p*blk, width) zero-padded global tensor
    gshape: tuple     # true (m, width)
    grid: Grid

    @property
    def block(self) -> int:
        """Rows owned per rank (uniform, padded)."""
        return _blk(self.gshape[0], self.grid.size)

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def width(self) -> int:
        return self.gshape[1]

    def row_owner(self, i: int) -> int:
        """Rank owning global row i (``DistMultiVec::RowOwner``)."""
        return i // self.block

    def with_local(self, local) -> "DistMultiVec":
        return dataclasses.replace(self, local=local)

    def __repr__(self):
        return (f"DistMultiVec(gshape={self.gshape}, grid={self.grid}, "
                f"dtype={self.local.dtype})")


def mv_from_global(arr, grid: Grid | None = None,
                   device_put: bool = True) -> DistMultiVec:
    """Build from a global (m, width) or (m,) array (numpy or tensor), the
    tail rows padded to p*blk.  ``device_put=False`` builds the storage on
    the device the array already lies on (the CPU for numpy input)."""
    grid = grid or default_grid()
    x = arr if isinstance(arr, torch.Tensor) \
        else torch.as_tensor(np.asarray(arr))
    if device_put:
        x = x.to(grid.device)
    if x.dim() == 1:
        x = x.reshape(-1, 1)
    m, w = x.shape
    blk = _blk(m, grid.size)
    stor = x.new_zeros((grid.size * blk, w))
    stor[:m] = x
    return DistMultiVec(stor, (m, w), grid)


def mv_to_global(v: DistMultiVec) -> torch.Tensor:
    """Recover the (m, width) matrix (tail padding dropped), as a fresh
    tensor."""
    return v.local[: v.gshape[0]].clone()


def mv_zeros(m: int, width: int = 1, grid: Grid | None = None,
             dtype=torch.float32) -> DistMultiVec:
    grid = grid or default_grid()
    blk = _blk(m, grid.size)
    stor = torch.zeros((grid.size * blk, width), dtype=dtype,
                       device=grid.device)
    return DistMultiVec(stor, (m, width), grid)


# ---- elementwise / reductions (padding-oblivious on the padded storage) ----

def mv_axpy(alpha, X: DistMultiVec, Y: DistMultiVec) -> DistMultiVec:
    _check_same(X, Y)
    return Y.with_local(alpha * X.local + Y.local)


def mv_scale(alpha, X: DistMultiVec) -> DistMultiVec:
    return X.with_local(alpha * X.local)


def mv_dot(X: DistMultiVec, Y: DistMultiVec) -> torch.Tensor:
    """<X, Y> = sum conj(X) * Y as a 0-d tensor (tail padding is zero on
    both sides)."""
    _check_same(X, Y)
    return torch.vdot(X.local.reshape(-1), Y.local.reshape(-1))


def mv_nrm2(X: DistMultiVec) -> torch.Tensor:
    """The Frobenius norm of the whole multivector, a 0-d tensor."""
    return torch.linalg.vector_norm(X.local)


def _check_same(X: DistMultiVec, Y: DistMultiVec):
    if X.gshape != Y.gshape or X.grid != Y.grid:
        raise ValueError(f"DistMultiVec mismatch: {X} vs {Y}")


# ---- batched remote updates (Reserve/QueueUpdate/ProcessQueues) ------

def _index_tensor(idx, device) -> torch.Tensor:
    """An int64 index tensor on ``device`` from numpy, a list or a tensor."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)


def _validate_update_indices(rows, cols, m: int, n: int, gshape) -> None:
    """Bounds check for queued remote updates (writes into the
    zero-padding tail would corrupt padding-oblivious reductions): one
    min / max reduction per index tensor and one host read."""
    if rows.numel() == 0:
        return
    lims = torch.stack([rows.min(), rows.max(), cols.min(), cols.max()])
    rlo, rhi, clo, chi = (int(v) for v in lims.cpu())
    if rlo < 0 or rhi >= m or clo < 0 or chi >= n:
        raise ValueError(f"remote update out of bounds for gshape {gshape}")


def mv_remote_updates(v: DistMultiVec, rows, cols, vals) -> DistMultiVec:
    """Apply a batch of ``v[rows[k], cols[k]] += vals[k]`` updates.

    The analog of the reference's queued ``RemoteUpdate`` +
    ``ProcessQueues``: callers batch arbitrary (possibly duplicate) global
    updates; one scatter-add on a copy of the storage lands them (the
    order of a duplicate's sums is the device's)."""
    m, w = v.gshape
    dev = v.local.device
    i = _index_tensor(rows, dev)
    j = _index_tensor(cols, dev)
    _validate_update_indices(i, j, m, w, v.gshape)
    x = vals if isinstance(vals, torch.Tensor) \
        else torch.as_tensor(np.asarray(vals))
    x = x.to(device=dev, dtype=v.dtype)
    out = v.local.clone()
    out.index_put_((i, j), x.expand(i.shape), accumulate=True)
    return v.with_local(out)


# ---- bridges to DistMatrix (API edge) --------------------------------

def mv_to_distmatrix(v: DistMultiVec, cdist=None, rdist=None):
    """Convert to a [MC,MR] (default) DistMatrix via the global bridge."""
    from .dist import MC, MR
    from .distmatrix import from_global
    cdist = MC if cdist is None else cdist
    rdist = MR if rdist is None else rdist
    return from_global(mv_to_global(v), cdist, rdist, grid=v.grid)


def mv_from_distmatrix(A) -> DistMultiVec:
    from .distmatrix import to_global
    return mv_from_global(to_global(A), grid=A.grid)
