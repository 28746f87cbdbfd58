"""BlockMatrix: the tiled second layout.

PyTorch port of ``elemental_tpu/core/block.py`` (the reference's
``DistMatrix<T,U,V,BLOCK>`` / ``BlockMatrix<T>``,
``include/El/core/DistMatrix/Block/**``): rank (i, j) owns the contiguous
tile rows [i*tr, (i+1)*tr) x cols [j*tc, (j+1)*tc) of the padded global
array (tr = ceil(m/r), tc = ceil(n/c)), while the elemental (cyclic)
``DistMatrix`` remains the load-balanced layout of the blocked
factorizations.

The storage IS the padded global array, so ``block_from_global`` /
``block_to_global`` are a pad and a slice; the cyclic <-> tiled
conversions are the per-dim index permutations between the two storage
orders (tiled row i <-> cyclic slot (i%r)*lr + i//r), one gather per
dimension on the grid's device.  Both are bit-equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import indexing as ix
from .dist import MC, MR
from .distmatrix import DistMatrix, _take_fill
from .grid import Grid, default_grid


@dataclasses.dataclass(frozen=True)
class BlockMatrix:
    """Tiled 2-D layout over the grid (see the module doc)."""
    local: Any                    # (r*tr, c*tc) padded global tensor
    gshape: tuple
    grid: Grid

    @property
    def tile_rows(self) -> int:
        return ix.max_local_length(self.gshape[0], self.grid.height)

    @property
    def tile_cols(self) -> int:
        return ix.max_local_length(self.gshape[1], self.grid.width)

    @property
    def dtype(self):
        return self.local.dtype

    def with_local(self, local) -> "BlockMatrix":
        return dataclasses.replace(self, local=local)

    def __repr__(self):
        return (f"BlockMatrix(gshape={self.gshape}, grid={self.grid}, "
                f"dtype={self.local.dtype})")


def block_from_global(arr, grid: Grid | None = None,
                      device_put: bool = True) -> BlockMatrix:
    """Wrap a global array (numpy or tensor) in the tiled layout: a fresh
    zero-padded tensor on ``grid.device`` (``device_put=False``: on the
    device the array already lies on)."""
    grid = grid or default_grid()
    x = arr if isinstance(arr, torch.Tensor) \
        else torch.as_tensor(np.asarray(arr))
    if device_put:
        x = x.to(grid.device)
    m, n = x.shape
    r, c = grid.height, grid.width
    tr, tc = ix.max_local_length(m, r), ix.max_local_length(n, c)
    pad = x.new_zeros((r * tr, c * tc))
    pad[:m, :n] = x
    return BlockMatrix(pad, (m, n), grid)


def block_from_array(arr, grid: Grid | None = None) -> BlockMatrix:
    """Adopt a tensor already laid out as the padded tiled array
    (zero-copy interop edge); shapes must be pre-padded."""
    grid = grid or default_grid()
    m, n = arr.shape
    return BlockMatrix(arr, (m, n), grid)


def block_to_global(B: BlockMatrix) -> torch.Tensor:
    """Recover the (m, n) matrix (tile padding sliced off), as a fresh
    tensor."""
    return B.local[: B.gshape[0], : B.gshape[1]].clone()


def _relayout(x: torch.Tensor, ridx: np.ndarray, cidx: np.ndarray
              ) -> torch.Tensor:
    """``x[ridx][:, cidx]`` with entries whose index is out of ``x``'s
    range set to zero, as a fresh tensor."""
    out = _take_fill(x, 0, ridx, x.shape[0])
    out = _take_fill(out, 1, cidx, x.shape[1])
    return out.clone() if out is x else out


def block_to_cyclic(B: BlockMatrix) -> DistMatrix:
    """BlockMatrix -> elemental [MC,MR] DistMatrix (one gather per dim)."""
    m, n = B.gshape
    g = B.grid
    r, c = g.height, g.width
    lr, lc = ix.max_local_length(m, r), ix.max_local_length(n, c)
    # cyclic storage slot q*l + t holds global index t*S + q
    s = np.arange(r * lr)
    ri = (s % lr) * r + s // lr
    t = np.arange(c * lc)
    cj = (t % lc) * c + t // lc
    bad = B.local.shape[0] + B.local.shape[1]        # past either extent
    ri = np.where(ri < m, ri, bad)
    cj = np.where(cj < n, cj, bad)
    return DistMatrix(_relayout(B.local, ri, cj), (m, n), MC, MR, 0, 0, g)


def block_from_cyclic(A: DistMatrix) -> BlockMatrix:
    """Elemental [MC,MR] DistMatrix -> BlockMatrix (inverse re-layout)."""
    if (A.cdist, A.rdist) != (MC, MR) or A.calign or A.ralign:
        raise ValueError("block_from_cyclic needs a zero-aligned [MC,MR]")
    m, n = A.gshape
    g = A.grid
    r, c = g.height, g.width
    lr, lc = A.local_rows, A.local_cols
    tr, tc = ix.max_local_length(m, r), ix.max_local_length(n, c)
    # tiled row i holds global i; its cyclic slot is (i%r)*lr + i//r
    i = np.arange(r * tr)
    j = np.arange(c * tc)
    bad = A.local.shape[0] + A.local.shape[1]
    ri = np.where(i < m, (i % r) * lr + i // r, bad)
    cj = np.where(j < n, (j % c) * lc + j // c, bad)
    return BlockMatrix(_relayout(A.local, ri, cj), (m, n), g)


def as_elemental(x) -> DistMatrix:
    """Read-proxy coercion (``DistMatrixReadProxy``): BlockMatrix operands
    convert to the elemental layout; DistMatrix passes through."""
    if isinstance(x, BlockMatrix):
        return block_to_cyclic(x)
    return x
