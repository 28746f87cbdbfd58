"""DistMatrix: a distributed matrix held as one stacked-storage tensor.

PyTorch port of ``elemental_tpu/core/distmatrix.py`` (the reference's
``DistMatrix<T,ColDist,RowDist>``, Elemental ``include/El/core/DistMatrix/``).
On a virtual grid one dataclass holds one tensor, ``local``: the
"stacked storage" array of shape ``(S_col*local_rows, S_row*local_cols)``,
whose tile (q_col, q_row) is rank (q_col, q_row)'s local cyclic block,
padded to the uniform extent ``ceil(extent/stride)`` with ZEROS.  The
layout is the JAX package's, bit for bit, so storage moves between the
two packages as a plain array (:func:`from_storage` /
:func:`storage_numpy`).

On a device grid ``local`` is a :class:`~.ranks.Tiles`: rank (mc, mr)'s
tile of that storage -- the JAX package's shard on mesh device (mc, mr)
-- on ``grid.devices[mc * c + mr]``, a tensor of its own.  A CIRC matrix
lives on rank 0 (the others hold empty blocks), as the JAX package puts
it on the mesh's first device.

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
                   storage_slot, md_slot_of_global)
from .grid import Grid, default_grid
from .ranks import Tiles, is_device_grid, per_rank, rank_map, refuse


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
    def local_shape(self) -> tuple:
        return (self.local_rows, self.local_cols)

    @property
    def dist(self) -> tuple:
        return (self.cdist, self.rdist)

    @property
    def dtype(self):
        return self.local.dtype

    # ---- functional update helpers ----------------------------------
    def with_local(self, local) -> "DistMatrix":
        return dataclasses.replace(self, local=local)

    def like(self, local, gshape=None) -> "DistMatrix":
        return dataclasses.replace(
            self, local=local, gshape=self.gshape if gshape is None else gshape
        )

    def astype(self, dtype) -> "DistMatrix":
        return self.with_local(per_rank(lambda rk, x: x.to(dtype), self.local))

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
    or tensor).  The result owns a fresh tensor on ``grid.device`` (on a
    device grid, one a rank on the rank's device)."""
    _check_pair(cdist, rdist)
    grid = grid or default_grid()
    if is_device_grid(grid):
        return _from_global_tiles(arr, cdist, rdist, grid, calign, ralign)
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
    if isinstance(A.local, Tiles):
        return _to_global_tiles(A)
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
    if is_device_grid(grid):
        lshape = _tile_shape((m, n), cdist, rdist, grid)
        loc = rank_map(grid, lambda rk, dev: torch.zeros(
            lshape if cdist is not Dist.CIRC or rk == (0, 0) else (0, 0),
            dtype=dtype, device=dev))
        return DistMatrix(loc, (m, n), cdist, rdist,
                          0 if cdist is Dist.CIRC else calign,
                          0 if cdist is Dist.CIRC else ralign, grid)
    if cdist is Dist.CIRC:
        return DistMatrix(torch.zeros((m, n), dtype=dtype, device=grid.device),
                          (m, n), cdist, rdist, 0, 0, grid)
    r, c = grid.height, grid.width
    qc, qr_ = storage_slots(cdist, r, c), storage_slots(rdist, r, c)
    sc, sr = dist_stride(cdist, r, c), dist_stride(rdist, r, c)
    lr, lc = ix.max_local_length(m, sc), ix.max_local_length(n, sr)
    stor = torch.zeros((qc * lr, qr_ * lc), dtype=dtype, device=grid.device)
    return DistMatrix(stor, (m, n), cdist, rdist, calign, ralign, grid)


def remote_updates(A: DistMatrix, rows, cols, vals) -> DistMatrix:
    """Batched global updates ``A[rows[k], cols[k]] += vals[k]`` -- the
    ``AxpyInterface`` / ``Reserve+QueueUpdate+ProcessQueues`` analog for
    DistMatrix (upstream ``include/El/core/AxpyInterface.hpp``): callers
    queue arbitrary (possibly duplicate) global updates and one
    scatter-add (``index_put_(accumulate=True)``) on a copy of the
    storage lands them.  The order in which duplicates are summed is the
    device's (atomics on the card), so results agree with a serial sum to
    rounding.

    Indices are bounds-checked first (one device reduction each); cyclic
    layouts only (MD/CIRC route through a redistribution first)."""
    from .multivec import _index_tensor, _validate_update_indices
    if isinstance(A.local, Tiles):
        refuse("remote_updates")
    if Dist.MD in A.dist or Dist.CIRC in A.dist:
        raise ValueError("remote_updates supports cyclic layouts; "
                         "redistribute MD/CIRC operands first")
    m, n = A.gshape
    dev = A.local.device
    i = _index_tensor(rows, dev)
    j = _index_tensor(cols, dev)
    _validate_update_indices(i, j, m, n, A.gshape)
    v = _as_tensor(vals, dev).to(A.dtype)
    sc, sr = A.col_stride, A.row_stride
    lr, lc = A.local_rows, A.local_cols
    si = ((i + A.calign) % sc) * lr + i // sc
    sj = ((j + A.ralign) % sr) * lc + j // sr
    out = A.local.clone()
    out.index_put_((si, sj), v.expand(si.shape), accumulate=True)
    return A.with_local(out)


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
    if is_device_grid(grid):
        return DistMatrix(_split_storage(arr, gshape, cdist, rdist, grid),
                          gshape, cdist, rdist, calign, ralign, grid)
    return DistMatrix(torch.as_tensor(arr, device=grid.device), gshape,
                      cdist, rdist, calign, ralign, grid)


def _numpy_dtype(dtype):
    """numpy twin of a torch dtype (``None`` when numpy has none, as for
    bfloat16)."""
    try:
        return torch.empty((), dtype=dtype).numpy().dtype
    except TypeError:
        return None


def storage_numpy(A: DistMatrix) -> np.ndarray:
    """The stacked storage of ``A`` as a host numpy array (the inverse of
    :func:`from_storage`)."""
    if isinstance(A.local, Tiles):
        return _join_storage(A)
    return A.local.detach().resolve_conj().cpu().numpy().copy()


# ---------------------------------------------------------------------
# the device grid's tiles
# ---------------------------------------------------------------------

def _tile_shape(gshape, cdist: Dist, rdist: Dist, grid: Grid) -> tuple:
    """Every rank's (padded) local block shape."""
    r, c = grid.height, grid.width
    return (ix.max_local_length(gshape[0], dist_stride(cdist, r, c)),
            ix.max_local_length(gshape[1], dist_stride(rdist, r, c)))


def _tile_index(extent: int, d: Dist, r: int, c: int, align: int,
                rank) -> np.ndarray:
    """The global index of each local position of ``rank``'s block along a
    ``d`` dimension (>= ``extent`` on padding): its slot of
    :func:`_storage_index_dim`."""
    full = _storage_index_dim(extent, d, r, c, align)
    ls = full.size // storage_slots(d, r, c)
    q = storage_slot(d, r, c, *rank)
    return full[q * ls:(q + 1) * ls]


def _tile_slots(A_dist, grid: Grid, rank) -> tuple:
    r, c = grid.height, grid.width
    return tuple(storage_slot(d, r, c, *rank) for d in A_dist)


def _from_global_tiles(arr, cdist, rdist, grid, calign, ralign) -> DistMatrix:
    """:func:`from_global` on a device grid: each rank takes its own block
    out of the global array, on its own device."""
    r, c = grid.height, grid.width
    on_dev: dict = {}

    def global_on(dev):
        if dev not in on_dev:
            on_dev[dev] = _as_tensor(arr, dev)
        return on_dev[dev]

    x0 = global_on(grid.devices[0])
    if x0.dim() != 2:
        raise ValueError(f"from_global needs a 2-D array, got {tuple(x0.shape)}")
    m, n = x0.shape
    if cdist is Dist.CIRC:
        loc = rank_map(grid, lambda rk, dev: global_on(dev).clone()
                       if rk == (0, 0) else x0.new_zeros((0, 0), device=dev))
        return DistMatrix(loc, (m, n), cdist, rdist, 0, 0, grid)

    def tile(rk, dev):
        x = global_on(dev)
        t = _take_fill(x, 0, _tile_index(m, cdist, r, c, calign, rk), m)
        t = _take_fill(t, 1, _tile_index(n, rdist, r, c, ralign, rk), n)
        return t.clone() if t is x else t

    return DistMatrix(rank_map(grid, tile), (m, n), cdist, rdist, calign,
                      ralign, grid)


def _to_global_tiles(A: DistMatrix) -> torch.Tensor:
    """:func:`to_global` on a device grid: the ranks' blocks land in one
    fresh tensor on the root rank's device (one rank per distinct
    block)."""
    g = A.grid
    m, n = A.gshape
    root = g.devices[0]
    if A.cdist is Dist.CIRC:
        return A.local[0].clone()
    r, c = g.height, g.width
    out = torch.zeros((m, n), dtype=A.dtype, device=root)
    seen = set()
    for d in range(g.size):
        rk = (d // c, d % c)
        slots = _tile_slots(A.dist, g, rk)
        if slots in seen:
            continue
        seen.add(slots)
        ri = _tile_index(m, A.cdist, r, c, A.calign, rk)
        cj = _tile_index(n, A.rdist, r, c, A.ralign, rk)
        rv, cv = np.flatnonzero(ri < m), np.flatnonzero(cj < n)
        if rv.size == 0 or cv.size == 0:
            continue
        t = A.local[d]
        blk = t.index_select(0, torch.as_tensor(rv, device=t.device))
        blk = blk.index_select(1, torch.as_tensor(cv, device=t.device))
        rows = torch.as_tensor(ri[rv], device=root)
        cols = torch.as_tensor(cj[cv], device=root)
        out[rows[:, None], cols[None, :]] = blk.to(root)
    return out


def _split_storage(arr: np.ndarray, gshape, cdist, rdist, grid) -> Tiles:
    """Stacked storage -> each rank's tile on its device."""
    if cdist is Dist.CIRC:
        return rank_map(grid, lambda rk, dev: torch.as_tensor(
            arr if rk == (0, 0) else arr[:0, :0], device=dev).clone())
    lr, lc = _tile_shape(gshape, cdist, rdist, grid)

    def tile(rk, dev):
        qr, qc = _tile_slots((cdist, rdist), grid, rk)
        blk = np.ascontiguousarray(arr[qr * lr:(qr + 1) * lr,
                                       qc * lc:(qc + 1) * lc])
        return torch.as_tensor(blk, device=dev).clone()

    return rank_map(grid, tile)


def _join_storage(A: DistMatrix) -> np.ndarray:
    """Each rank's tile -> the stacked storage, as a host numpy array."""
    host = [t.detach().resolve_conj().cpu().numpy() for t in A.local]
    if A.cdist is Dist.CIRC:
        return host[0].copy()
    g = A.grid
    lr, lc = A.local_shape
    out = np.zeros(_storage_shape(A.gshape, A.cdist, A.rdist, g),
                   dtype=host[0].dtype)
    for d, blk in enumerate(host):
        qr, qc = _tile_slots(A.dist, g, (d // g.width, d % g.width))
        out[qr * lr:(qr + 1) * lr, qc * lc:(qc + 1) * lc] = blk
    return out
