"""Sparse matrices: queue-built COO, row-block distributed, SpMV.

PyTorch port of ``elemental_tpu/sparse/core.py`` (``El::Graph`` /
``DistGraph``, ``El::SparseMatrix`` / ``DistSparseMatrix``, ``El::DistMap``
-- ``include/El/core/*``).

* **Build = host-side queues, freeze = device tensors.**  ``freeze()``
  returns the immutable :class:`DistSparseMatrix` whose three (p, k)
  tensors are the JAX package's storage bit for bit: ``vals``,
  ``rows_loc`` (int32, rank-local rows) and ``cols`` (int32, global
  columns), each rank's triplets sorted by (row, column) and padded with
  (0, 0, 0) no-ops to the largest per-rank count k.  The same triplets
  give the same arrays in both packages.
* **Row-block ownership over the p ranks of the virtual grid**, matching
  ``DistMultiVec``: rank d owns rows [d*blk, (d+1)*blk).  All ranks share
  one device, so the JAX ``all_gather`` of x is a plain read of x's
  padded storage and the adjoint's ``psum`` one sum into the padded
  output.
* **Deterministic SpMV.**  The JAX body is a gather and a scatter-add;
  a scatter-add on the card (``index_add_``) uses floating-point atomics,
  whose order changes from run to run.  Here each product sums its
  terms as fixed segment trees instead: the triplets are ordered by
  output row (``spmv``) or by output column (``spmv_adjoint``) once, on
  the host, and each level of the tree gathers at most
  :data:`SEGMENT_WIDTH` terms of a segment into one row of an index
  matrix and sums that row.  Two calls on the same inputs give the same
  bits; against XLA's scatter order the sums differ in the last bits.
  The plan depends only on the structure, so :meth:`with_values` keeps
  it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.grid import Grid, default_grid
from ..core.multivec import DistMultiVec, _blk
from ..core.dist import MC, MR


#: the most terms one row of a segment-sum level adds (a power of two)
SEGMENT_WIDTH = 32


# ---------------------------------------------------------------------
# Graph / DistGraph (structure-only; El::Graph, El::DistGraph)
# ---------------------------------------------------------------------

class Graph:
    """Adjacency structure built by queued edge insertion.

    ``El::Graph``: ``QueueConnection(s, t)`` + ``ProcessQueues``; here the
    frozen form is the sorted, deduplicated (sources, targets) pair."""

    def __init__(self, num_sources: int, num_targets: int | None = None):
        self.num_sources = num_sources
        self.num_targets = num_sources if num_targets is None else num_targets
        self._q: list[tuple[int, int]] = []
        self._frozen = None

    def queue_connection(self, s: int, t: int) -> None:
        if not (0 <= s < self.num_sources and 0 <= t < self.num_targets):
            raise ValueError(f"edge ({s},{t}) out of bounds")
        self._q.append((s, t))
        self._frozen = None

    def process_queues(self):
        """Sort + dedup; returns (sources, targets) int arrays."""
        if self._frozen is None:
            if self._q:
                st = np.unique(np.asarray(self._q, np.int64), axis=0)
            else:
                st = np.zeros((0, 2), np.int64)
            self._frozen = (st[:, 0].copy(), st[:, 1].copy())
        return self._frozen

    @property
    def num_edges(self) -> int:
        return len(self.process_queues()[0])


class DistGraph(Graph):
    """Row-block distributed adjacency (``El::DistGraph``): same build API;
    the partition is implied by the owning ``DistSparseMatrix``."""

    def __init__(self, num_sources: int, num_targets: int | None = None,
                 grid: Grid | None = None):
        super().__init__(num_sources, num_targets)
        self.grid = grid or default_grid()


# ---------------------------------------------------------------------
# DistMap (El::DistMap): distributed permutation for reorderings
# ---------------------------------------------------------------------

class DistMap:
    """A permutation of [0, n) applied to DistMultiVec rows.

    ``El::DistMap`` stores the image distributed; here the image vector is
    replicated metadata (n host ints) and application is one row gather
    on the padded storage."""

    def __init__(self, image, grid: Grid | None = None):
        self.image = np.asarray(image, np.int64)
        n = self.image.shape[0]
        if sorted(self.image.tolist()) != list(range(n)):
            raise ValueError("DistMap image is not a permutation")
        self.grid = grid or default_grid()

    @property
    def size(self) -> int:
        return self.image.shape[0]

    def inverse(self) -> "DistMap":
        inv = np.empty_like(self.image)
        inv[self.image] = np.arange(self.size)
        return DistMap(inv, self.grid)

    def translate(self, v: DistMultiVec) -> DistMultiVec:
        """w[image[i]] = v[i] (``DistMap::Translate``)."""
        m = v.gshape[0]
        if m != self.size:
            raise ValueError(f"DistMap size {self.size} vs vector rows {m}")
        inv = self.inverse().image
        pad = v.local.shape[0] - m
        idx = np.concatenate([inv, np.arange(m, m + pad)])
        return v.with_local(v.local.index_select(
            0, torch.as_tensor(idx, device=v.local.device)))


# ---------------------------------------------------------------------
# deterministic segment sums (the SpMV's reduction)
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _SumPlan:
    """Levels of a fixed segment-sum tree over K terms into ``nout``
    outputs: ``levels[i]`` is an (rows_i, W_i) index matrix into the
    previous level's values (level 0: into the K terms), the index one
    past the end naming an appended zero; ``out_idx`` the output each
    row of the last level lands in (all distinct)."""
    levels: tuple
    out_idx: Any
    nout: int

    def apply(self, terms):
        """Sum the (K, w) ``terms`` into (nout, w)."""
        v = terms
        for idx in self.levels:
            v = torch.cat([v, v.new_zeros((1,) + v.shape[1:])])[idx].sum(1)
        out = terms.new_zeros((self.nout,) + terms.shape[1:])
        return out.index_copy_(0, self.out_idx, v)


def _sum_plan(keys: np.ndarray, nout: int, device) -> _SumPlan:
    """The :class:`_SumPlan` of terms whose outputs are ``keys`` (host
    ints): terms ordered by key (stable: storage order within a key),
    each key's run cut into chunks of W = min(next power of two of the
    longest run, :data:`SEGMENT_WIDTH`) terms, one level per cut, until
    each key has one partial sum."""
    order = np.argsort(keys, kind="stable")
    cur = keys[order]
    src, n_in = order, keys.size
    levels = []
    while True:
        starts = np.flatnonzero(np.r_[True, cur[1:] != cur[:-1]])
        lens = np.diff(np.r_[starts, cur.size])
        width = min(1 << int(np.ceil(np.log2(max(int(lens.max()), 1)))),
                    SEGMENT_WIDTH)
        nch = -(-lens // width)
        first = np.cumsum(nch) - nch
        chunk = np.arange(int(nch.sum()))
        lo = np.repeat(starts, nch) + width * (chunk - np.repeat(first, nch))
        hi = np.repeat(starts + lens, nch)
        pos = lo[:, None] + np.arange(width)[None, :]
        idx = np.where(pos < hi[:, None], src[np.minimum(pos, cur.size - 1)],
                       n_in)
        levels.append(torch.as_tensor(idx, dtype=torch.int64, device=device))
        cur = np.repeat(cur[starts], nch)
        if int(nch.max()) == 1:
            break
        src, n_in = np.arange(cur.size), cur.size
    return _SumPlan(tuple(levels),
                    torch.as_tensor(cur, dtype=torch.int64, device=device),
                    nout)


# ---------------------------------------------------------------------
# DistSparseMatrix: frozen (p, k) row-block COO
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistSparseMatrix:
    """Frozen row-block COO matrix (fields = per-rank triplet tensors).

    ``rows_loc``: (p, k) int32 LOCAL row offsets (global row = d*blk +
    rows_loc[d]); ``cols``: (p, k) int32 global column ids; ``vals``:
    (p, k) values, all on ``grid.device``; padding entries are (0, 0, 0)
    no-ops.  ``nnz`` / ``gshape`` / ``grid`` are metadata.  The segment
    sum plans of the two products are built at first use from the
    structure and kept beside the fields (:meth:`with_values` shares
    them).
    """
    vals: Any
    rows_loc: Any
    cols: Any
    gshape: tuple
    nnz: int
    grid: Grid

    def __post_init__(self):
        object.__setattr__(self, "_plans", {})

    @property
    def dtype(self):
        return self.vals.dtype

    def with_values(self, vals) -> "DistSparseMatrix":
        """New numbers on the same frozen structure (IPM refactor path)."""
        out = dataclasses.replace(self, vals=vals)
        object.__setattr__(out, "_plans", self._plans)
        return out

    def __repr__(self):
        return (f"DistSparseMatrix(gshape={self.gshape}, nnz={self.nnz}, "
                f"grid={self.grid})")

    # ---- the products' plans -----------------------------------------

    def _global_rows(self, rl: np.ndarray) -> np.ndarray:
        blk = _blk(self.gshape[0], self.grid.size)
        return (rl.astype(np.int64)
                + blk * np.arange(rl.shape[0])[:, None]).reshape(-1)

    def _plan(self, which: str, host=None) -> _SumPlan:
        """The segment-sum plan of ``'spmv'`` (terms by global row) or
        ``'adjoint'`` (terms by column); ``host`` = the (rows_loc, cols)
        numpy arrays when the caller has them (else one copy from the
        device)."""
        plan = self._plans.get(which)
        if plan is None:
            m, n = self.gshape
            p = self.grid.size
            if host is None:
                host = (self.rows_loc.cpu().numpy(), self.cols.cpu().numpy())
            rl, cl = host
            dev = self.vals.device
            if which == "spmv":
                plan = _sum_plan(self._global_rows(rl), p * _blk(m, p), dev)
            else:
                plan = _sum_plan(cl.astype(np.int64).reshape(-1),
                                 p * _blk(n, p), dev)
            self._plans[which] = plan
        return plan

    def _row_index(self):
        idx = self._plans.get("rows")
        if idx is None:
            blk = _blk(self.gshape[0], self.grid.size)
            rl = self.rows_loc.to(torch.int64)
            idx = (rl + blk * torch.arange(rl.shape[0], device=rl.device)
                   [:, None]).reshape(-1)
            self._plans["rows"] = idx
        return idx

    # ---- SpMV --------------------------------------------------------

    def spmv(self, x: DistMultiVec, alpha=1.0) -> DistMultiVec:
        """y = alpha * A x (``El::Multiply(NORMAL, ...)``)."""
        if x.gshape[0] != self.gshape[1]:
            raise ValueError(f"A is {self.gshape}, x has {x.gshape[0]} rows")
        return _spmv(self, x, alpha)

    def spmv_adjoint(self, x: DistMultiVec, alpha=1.0) -> DistMultiVec:
        """y = alpha * A^H x (``El::Multiply(ADJOINT, ...)``)."""
        if x.gshape[0] != self.gshape[0]:
            raise ValueError(f"A^H needs {self.gshape[0]} rows, "
                             f"x has {x.gshape[0]}")
        return _spmv_adjoint(self, x, alpha)

    # ---- bridges -----------------------------------------------------

    def to_dense(self):
        """Materialize as a [MC,MR] DistMatrix (small problems / tests)."""
        from ..core.distmatrix import from_global
        m, n = self.gshape
        rg = self._global_rows(self.rows_loc.cpu().numpy())
        vals = self.vals.cpu().numpy()
        dense = np.zeros((m, n), vals.dtype)
        np.add.at(dense, (np.minimum(rg, m - 1),
                          self.cols.cpu().numpy().reshape(-1)),
                  vals.reshape(-1))
        return from_global(dense, MC, MR, grid=self.grid)


def _spmv(A: DistSparseMatrix, x: DistMultiVec, alpha) -> DistMultiVec:
    """y = alpha A x: the terms vals * x[cols] (x's padded storage is the
    JAX ``all_gather``'s tiled result), summed by row.  A Python
    ``alpha`` multiplies as a kernel argument (no host-to-device copy, so
    the product can be captured in a CUDA graph)."""
    m, _ = A.gshape
    terms = A.vals.reshape(-1, 1) * x.local.index_select(
        0, A.cols.reshape(-1).to(torch.int64))
    y = A._plan("spmv").apply(terms)
    return DistMultiVec(alpha * y, (m, x.width), A.grid)


def _spmv_adjoint(A: DistSparseMatrix, x: DistMultiVec,
                  alpha) -> DistMultiVec:
    """y = alpha A^H x: the terms conj(vals) * x[rows], summed by column
    into the padded (p * blk_n) output (the JAX ``psum``)."""
    _, n = A.gshape
    v = A.vals.reshape(-1, 1)
    terms = (v.conj() if v.is_complex() else v) * x.local.index_select(
        0, A._row_index())
    y = A._plan("adjoint").apply(terms)
    return DistMultiVec(alpha * y, (n, x.width), A.grid)


# ---------------------------------------------------------------------
# Construction (queued updates, COO)
# ---------------------------------------------------------------------

class SparseMatrix:
    """Sequential/queue-building front end (``El::SparseMatrix``).

    ``queue_update(i, j, v)`` batches entries (duplicates sum);
    ``freeze(grid)`` coalesces and returns the immutable
    ``DistSparseMatrix`` (1x1 grid => sequential semantics)."""

    def __init__(self, m: int, n: int | None = None):
        self.m = m
        self.n = m if n is None else n
        self._i: list[int] = []
        self._j: list[int] = []
        self._v: list[float] = []

    def queue_update(self, i: int, j: int, v) -> None:
        if not (0 <= i < self.m and 0 <= j < self.n):
            raise ValueError(f"entry ({i},{j}) out of bounds "
                             f"for {self.m}x{self.n}")
        self._i.append(i); self._j.append(j); self._v.append(v)

    def freeze(self, grid: Grid | None = None, dtype=None) -> DistSparseMatrix:
        return dist_sparse_from_coo(self._i, self._j, self._v,
                                    self.m, self.n, grid=grid, dtype=dtype)


def sparse_from_coo(rows, cols, vals, m: int, n: int,
                    dtype=None) -> DistSparseMatrix:
    """COO -> frozen sparse matrix on the default grid."""
    return dist_sparse_from_coo(rows, cols, vals, m, n, dtype=dtype)


def dist_sparse_from_coo(rows, cols, vals, m: int, n: int,
                         grid: Grid | None = None, dtype=None,
                         pad_to: int | None = None) -> DistSparseMatrix:
    """Coalesce (sum duplicates), partition by row-block owner, pad each
    rank's triplet list to the max count (or ``pad_to``), freeze to
    tensors on the grid's device (the JAX package's arrays bit for
    bit); the row-sum plan of ``spmv`` is built here from the host
    arrays."""
    grid = grid or default_grid()
    p = grid.size
    rows = np.asarray(rows, np.int64).reshape(-1)
    cols = np.asarray(cols, np.int64).reshape(-1)
    vals = np.asarray(vals).reshape(-1)
    if dtype is not None:
        vals = vals.astype(dtype)
    if rows.size:
        if rows.min() < 0 or rows.max() >= m or cols.min() < 0 \
                or cols.max() >= n:
            raise ValueError("COO indices out of bounds")
        key = rows * n + cols
        order = np.argsort(key, kind="stable")
        key, vals = key[order], vals[order]
        uniq, start = np.unique(key, return_index=True)
        vals = np.add.reduceat(vals, start)
        rows, cols = uniq // n, uniq % n
    nnz = rows.size
    blk = _blk(m, p)
    owner = rows // blk
    k = max(int(np.bincount(owner, minlength=p).max()) if nnz else 0, 1)
    if pad_to is not None:
        if pad_to < k:
            raise ValueError(f"pad_to={pad_to} < required per-device {k}")
        k = pad_to
    R = np.zeros((p, k), np.int32)
    C = np.zeros((p, k), np.int32)
    V = np.zeros((p, k), vals.dtype)
    for d in range(p):
        sel = owner == d
        cnt = int(sel.sum())
        R[d, :cnt] = rows[sel] - d * blk
        C[d, :cnt] = cols[sel]
        V[d, :cnt] = vals[sel]
    dev = grid.device
    A = DistSparseMatrix(torch.as_tensor(V, device=dev),
                         torch.as_tensor(R, device=dev),
                         torch.as_tensor(C, device=dev),
                         (m, n), nnz, grid)
    A._plan("spmv", host=(R, C))
    return A


def sparse_to_coo(A: DistSparseMatrix):
    """Host (rows, cols, vals) triplets of a DistSparseMatrix (padding
    no-ops dropped) -- the inverse of :func:`dist_sparse_from_coo`."""
    rg = A._global_rows(A.rows_loc.cpu().numpy())
    cg = A.cols.cpu().numpy().reshape(-1)
    vg = A.vals.cpu().numpy().reshape(-1)
    keep = vg != 0
    return rg[keep], cg[keep], vg[keep]
