"""Basic matrix constructors: zeros, ones, identity, Hilbert, Lehmer,
min(i,j), and the host-seeded random ones.

PyTorch port of ``elemental_tpu/matrices/basic.py`` (Elemental
``src/matrices/``).  Deterministic constructors ride the level-1
index-dependent fill on the grid's device; random ones draw on the host
with numpy from ``seed`` and enter through ``from_global``, so their
stacked storage is bit-equal to the JAX package's for the same seed.
"""
from __future__ import annotations

import numpy as np
import torch

from ..blas.level1 import (_global_indices, fill, index_dependent_fill)
from ..core.dist import MC, MR
from ..core.distmatrix import (DistMatrix, _numpy_dtype, from_global,
                               zeros as dm_zeros)
from ..core.grid import Grid, default_grid


def _f64(i):
    """An index tensor as float64 (JAX's default float under x64, where an
    integer index meets a Python float)."""
    return i.to(torch.float64)


def _empty(m, n, grid, dtype, cdist=MC, rdist=MR):
    return dm_zeros(m, n, cdist, rdist, grid, dtype=dtype)


def zeros(m: int, n: int | None = None, grid: Grid | None = None,
          dtype=torch.float32) -> DistMatrix:
    return _empty(m, n or m, grid or default_grid(), dtype)


def ones(m: int, n: int | None = None, grid: Grid | None = None,
         dtype=torch.float32) -> DistMatrix:
    return fill(_empty(m, n or m, grid or default_grid(), dtype), 1)


def identity(m: int, n: int | None = None, grid: Grid | None = None,
             dtype=torch.float32) -> DistMatrix:
    """The (m, n) identity ([MC,MR]; ``n`` defaults to ``m``)."""
    A = _empty(m, n or m, grid or default_grid(), dtype)
    I, J = _global_indices(A)
    on = (J[None, :] == I[:, None]) & (I[:, None] < m) \
        & (J[None, :] < (n or m))
    return A.with_local(A.local + on.to(dtype))


def hilbert(n: int, grid: Grid | None = None,
            dtype=torch.float64) -> DistMatrix:
    A = _empty(n, n, grid or default_grid(), dtype)
    return index_dependent_fill(
        A, lambda i, j: (1.0 / _f64(i + j + 1)).to(dtype))


def lehmer(n: int, grid: Grid | None = None,
           dtype=torch.float64) -> DistMatrix:
    A = _empty(n, n, grid or default_grid(), dtype)
    return index_dependent_fill(
        A, lambda i, j: (torch.minimum(i, j) + 1).to(dtype)
        / (torch.maximum(i, j) + 1))


def minij(n: int, grid: Grid | None = None,
          dtype=torch.float64) -> DistMatrix:
    A = _empty(n, n, grid or default_grid(), dtype)
    return index_dependent_fill(
        A, lambda i, j: (torch.minimum(i, j) + 1).to(dtype))


# ---- random (host-side numpy draws, layout-independent) ----------------

def uniform(m: int, n: int | None = None, grid: Grid | None = None,
            dtype=torch.float32, seed: int = 0, lo=0.0,
            hi=1.0) -> DistMatrix:
    n = n or m
    rng = np.random.default_rng(seed)
    F = rng.uniform(lo, hi, size=(m, n)).astype(_numpy_dtype(dtype))
    return from_global(F, MC, MR, grid or default_grid())


def gaussian(m: int, n: int | None = None, grid: Grid | None = None,
             dtype=torch.float32, seed: int = 0) -> DistMatrix:
    n = n or m
    rng = np.random.default_rng(seed)
    dt = _numpy_dtype(dtype)
    if np.issubdtype(dt, np.complexfloating):
        F = (rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))).astype(dt)
    else:
        F = rng.normal(size=(m, n)).astype(dt)
    return from_global(F, MC, MR, grid or default_grid())


def hermitian_uniform_spectrum(n: int, lo=1.0, hi=2.0,
                               grid: Grid | None = None,
                               dtype=torch.float64,
                               seed: int = 0) -> DistMatrix:
    """HPD test matrix with a known uniform spectrum
    (``El::HermitianUniformSpectrum``): Q diag(u) Q^H, Q Haar via QR."""
    rng = np.random.default_rng(seed)
    dt = _numpy_dtype(dtype)
    if np.issubdtype(dt, np.complexfloating):
        G = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    else:
        G = rng.normal(size=(n, n))
    Q, _ = np.linalg.qr(G)
    d = rng.uniform(lo, hi, size=n)
    A = (Q * d) @ Q.conj().T
    A = (A + A.conj().T) / 2
    return from_global(A.astype(dt), MC, MR, grid or default_grid())
