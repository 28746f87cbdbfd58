"""IO: print, write, read, checkpoint, Matrix Market, display.

PyTorch port of ``elemental_tpu/io/core.py`` (Elemental ``src/io/`` --
``Print.cpp``, ``Write.cpp``/``Read.cpp`` with the ASCII / BINARY /
BINARY_FLAT / MATRIX_MARKET formats, ``Display``, ``Spy``).

``to_global`` is the ``[CIRC,CIRC]`` gather; the ``"shards"`` format
dumps the stacked-storage array as-is plus its layout metadata (an
``.npz`` with ``storage`` and a JSON ``meta``, the JAX package's file
format key for key), reloadable into the SAME grid shape without forming
the global matrix.  The storage is the JAX package's bit for bit, so a
checkpoint written by either package restores in the other.
``display`` / ``spy`` import matplotlib when called.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..core.dist import Dist, MC, MR
from ..core.distmatrix import (DistMatrix, from_global, to_global,
                               storage_numpy)
from ..core.grid import Grid, default_grid


def print_matrix(A: DistMatrix, title: str = "", stream=None,
                 precision: int = 6):
    """Formatted print of the global matrix (``El::Print``; gathers through
    the [CIRC,CIRC]-analog bridge)."""
    import sys
    stream = stream or sys.stdout
    arr = to_global(A).cpu().numpy()
    if title:
        stream.write(f"{title}\n")
    with np.printoptions(precision=precision, suppress=False,
                         linewidth=120, threshold=10000):
        stream.write(f"{arr}\n")


def write_matrix(A: DistMatrix, path: str, format: str = "npy") -> None:
    """Write a DistMatrix (``El::Write``).

    ``format``:
      * 'npy'    -- the GLOBAL matrix as a standard .npy (BINARY analog;
        gathers to host -- interoperable, not for at-scale operands).
      * 'shards' -- the stacked-storage array + layout metadata as
        ``<path>.npz`` (BINARY_FLAT analog; no global gather, reload
        requires an identical grid shape).
    """
    if format == "npy":
        np.save(path, to_global(A).cpu().numpy())
        return
    if format == "shards":
        meta = dict(gshape=list(A.gshape), cdist=A.cdist.value,
                    rdist=A.rdist.value, calign=A.calign, ralign=A.ralign,
                    grid=[A.grid.height, A.grid.width])
        np.savez(path, storage=storage_numpy(A),
                 meta=json.dumps(meta))
        return
    raise ValueError(f"unknown format {format!r}")


def read_matrix(path: str, cdist: Dist = MC, rdist: Dist = MR,
                grid: Grid | None = None) -> DistMatrix:
    """Read a matrix written by :func:`write_matrix` (``El::Read``)."""
    grid = grid or default_grid()
    if path.endswith(".npz") or os.path.exists(path + ".npz"):
        p = path if path.endswith(".npz") else path + ".npz"
        data = np.load(p, allow_pickle=False)
        meta = json.loads(str(data["meta"]))
        if meta["grid"] != [grid.height, grid.width]:
            raise ValueError(
                f"shard checkpoint was written on a {meta['grid']} grid; "
                f"reload on {[grid.height, grid.width]} requires the global "
                "'npy' format (cross-grid TranslateBetweenGrids analog)")
        d = Dist(meta["cdist"]), Dist(meta["rdist"])
        return DistMatrix(torch.as_tensor(data["storage"],
                                          device=grid.device),
                          tuple(meta["gshape"]), d[0], d[1],
                          meta["calign"], meta["ralign"], grid)
    p = path if path.endswith(".npy") else path + ".npy"
    return from_global(np.load(p), cdist, rdist, grid=grid)


def checkpoint(path: str, **named: DistMatrix) -> None:
    """Write a named set of DistMatrices as shard files under ``path``
    (SURVEY.md §6.4 checkpoint/resume building block)."""
    os.makedirs(path, exist_ok=True)
    for name, A in named.items():
        write_matrix(A, os.path.join(path, name), format="shards")


def restore(path: str, names, grid: Grid | None = None) -> dict:
    """Reload a :func:`checkpoint` directory; returns {name: DistMatrix}."""
    return {name: read_matrix(os.path.join(path, name), grid=grid)
            for name in names}


# ---------------------------------------------------------------------
# Matrix Market + Display/Spy (SURVEY.md §3.5 IO row completion)
# ---------------------------------------------------------------------

def _mm_body(*columns) -> str:
    """Bulk-format numeric columns into MatrixMarket body lines.

    numpy C-level string ops (``np.char.mod`` per column + joins) instead
    of a per-entry Python format loop -- the body of an m x n dense write
    is O(mn) work either way, but this keeps it out of the interpreter
    (~30x on the 1e6-entry matrices this library considers small)."""
    parts = [np.char.mod("%d", col) if np.issubdtype(col.dtype, np.integer)
             else np.char.mod("%.17g", col) for col in columns]
    out = parts[0]
    for p in parts[1:]:
        out = np.char.add(np.char.add(out, " "), p)
    return "\n".join(out)


def write_matrix_market(A, path: str, comment: str = "") -> None:
    """Write to MatrixMarket format (``El::Write`` MATRIX_MARKET): dense
    DistMatrix -> 'array' format; DistSparseMatrix -> 'coordinate'.
    Bodies are numpy-bulk-formatted (:func:`_mm_body`), no per-entry
    Python loop."""
    from ..sparse.core import DistSparseMatrix
    if isinstance(A, DistSparseMatrix):
        from ..sparse.core import sparse_to_coo
        rows, cols, vals = sparse_to_coo(A)
        rows = np.asarray(rows, np.int64) + 1
        cols = np.asarray(cols, np.int64) + 1
        m, n = A.gshape
        cplx = np.iscomplexobj(vals)
        field = "complex" if cplx else "real"
        with open(path, "w") as f:
            f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
            if comment:
                f.write(f"% {comment}\n")
            f.write(f"{m} {n} {len(vals)}\n")
            if len(vals):
                body = _mm_body(rows, cols, vals.real, vals.imag) if cplx \
                    else _mm_body(rows, cols, vals)
                f.write(body + "\n")
        return
    arr = to_global(A).cpu().numpy()
    m, n = arr.shape
    cplx = np.iscomplexobj(arr)
    field = "complex" if cplx else "real"
    flat = arr.flatten(order="F")        # column-major per the MM spec
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix array {field} general\n")
        if comment:
            f.write(f"% {comment}\n")
        f.write(f"{m} {n}\n")
        if flat.size:
            body = _mm_body(flat.real, flat.imag) if cplx else _mm_body(flat)
            f.write(body + "\n")


def read_matrix_market(path: str, grid: Grid | None = None, sparse=None):
    """Read MatrixMarket (``El::Read`` MATRIX_MARKET): 'array' ->
    DistMatrix [MC,MR]; 'coordinate' -> DistSparseMatrix (or a dense
    DistMatrix when ``sparse=False``).  Symmetric/hermitian/skew files
    are expanded to general storage."""
    with open(path) as f:
        header = f.readline().strip().lower().split()
        if len(header) < 5 or header[0] != "%%matrixmarket":
            raise ValueError(f"not a MatrixMarket file: {path}")
        _, obj, fmt, field, symm = header[:5]
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        dims = line.split()
        if fmt == "coordinate":
            m, n, nnz = int(dims[0]), int(dims[1]), int(dims[2])
            # bulk parse: one read + one numpy conversion for all triplets
            # (loadtxt-style; no per-line Python loop)
            ncol = {"pattern": 2, "complex": 4}.get(field, 3)
            toks = np.array(f.read().split(), dtype=np.str_)
            if toks.size < nnz * ncol:
                raise ValueError(
                    f"truncated MatrixMarket body: {toks.size} tokens for "
                    f"{nnz} x {ncol} entries in {path}")
            data = toks[: nnz * ncol].reshape(nnz, ncol)
            rows = data[:, 0].astype(np.int64) - 1
            cols = data[:, 1].astype(np.int64) - 1
            if field == "pattern":
                vals = np.ones(nnz, np.float64)
            elif field == "complex":
                vals = data[:, 2].astype(np.float64) \
                    + 1j * data[:, 3].astype(np.float64)
            else:
                vals = data[:, 2].astype(np.float64)
            if symm in ("symmetric", "hermitian", "skew-symmetric"):
                off = rows != cols
                r2, c2, v2 = cols[off], rows[off], vals[off]
                if symm == "hermitian":
                    v2 = np.conj(v2)
                elif symm == "skew-symmetric":
                    v2 = -v2
                rows = np.concatenate([rows, r2])
                cols = np.concatenate([cols, c2])
                vals = np.concatenate([vals, v2])
            from ..sparse.core import dist_sparse_from_coo
            if sparse is False:
                dense = np.zeros((m, n), vals.dtype)
                np.add.at(dense, (rows, cols), vals)
                return from_global(dense, MC, MR, grid=grid)
            return dist_sparse_from_coo(rows, cols, vals, m, n, grid=grid)
        m, n = int(dims[0]), int(dims[1])
        data = np.array(f.read().split(), np.float64)
        if field == "complex":
            data = data[0::2] + 1j * data[1::2]
        if symm in ("symmetric", "hermitian", "skew-symmetric"):
            # packed lower triangle, column-major; skew files omit the
            # (zero) diagonal, storing only the strictly-lower part
            skew = symm == "skew-symmetric"
            arr = np.zeros((m, n), data.dtype)
            at = 0
            for j in range(n):
                lo = j + 1 if skew else j
                cnt = m - lo
                arr[lo:, j] = data[at:at + cnt]
                at += cnt
            up = arr.T.copy()
            if symm == "hermitian":
                up = up.conj()
            elif skew:
                up = -up
            arr = arr + up - np.diag(np.diag(arr))
        else:
            arr = data[: m * n].reshape((n, m)).T    # column-major
        return from_global(arr, MC, MR, grid=grid)


def display(A, title: str = "", path: str | None = None, cmap="viridis"):
    """Heat-map dump of |A| (``El::Display``; matplotlib instead of Qt5 --
    SURVEY.md §3.7 item 6).  Saves to ``path`` (default: <title>.png)."""
    from matplotlib.figure import Figure
    from ..sparse.core import DistSparseMatrix
    if isinstance(A, DistSparseMatrix):
        A = A.to_dense()                # a heat map is dense by nature
    arr = to_global(A).cpu().numpy()
    fig = Figure(figsize=(6, 5))        # Agg canvas; no global-backend switch
    ax = fig.add_subplot()
    im = ax.imshow(np.abs(arr), aspect="auto", cmap=cmap,
                   interpolation="nearest")
    fig.colorbar(im, ax=ax)
    ax.set_title(title or "DistMatrix")
    out = path or f"{(title or 'matrix').replace(' ', '_')}.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    return out


def spy(A, tol: float = 0.0, title: str = "", path: str | None = None):
    """Sparsity portrait (``El::Spy``): marks |A_ij| > tol."""
    from matplotlib.figure import Figure
    from ..sparse.core import DistSparseMatrix, sparse_to_coo
    fig = Figure(figsize=(6, 6))        # Agg canvas; no global-backend switch
    ax = fig.add_subplot()
    if isinstance(A, DistSparseMatrix):
        # plot the triplets directly: O(nnz), never a dense m x n mask
        rows, cols, vals = sparse_to_coo(A)
        keep = np.abs(vals) > tol
        m, n = A.gshape
        ax.plot(cols[keep], rows[keep], ".", markersize=2)
        ax.set_xlim(-0.5, n - 0.5)
        ax.set_ylim(m - 0.5, -0.5)
        ax.set_aspect("equal")
        nnz = int(keep.sum())
    else:
        arr = to_global(A).cpu().numpy()
        mask = np.abs(arr) > tol
        ax.spy(mask, markersize=2)
        nnz = int(mask.sum())
    ax.set_title(title or f"nnz = {nnz}")
    out = path or f"{(title or 'spy').replace(' ', '_')}.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    return out
