"""Cyclic-layout index arithmetic.

The element-cyclic distribution of the reference (Elemental's
``include/El/core/environment`` ``Shift``/``Length`` helpers, used by every
pack/unpack loop in ``src/blas_like/level1/Copy/``) boils down to four pure
functions on plain ints (PyTorch port of ``elemental_tpu/core/indexing.py``;
the virtual grid knows every rank on the host, so no traced variants).

Layout convention (matching Elemental): a 1-D index space of extent ``n``
distributed with stride ``S`` (number of owning ranks) and alignment ``a``:

  * owner(i)        = (i + a) mod S            -- rank that owns global index i
  * shift(q)        = (q - a) mod S            -- first global index owned by q
  * local index     iLoc = i // S
  * global index    i = iLoc * S + shift(q)
  * local length    Length(n, shift, S) = ceil((n - shift) / S)

All ranks store ``max_local_length(n, S) = ceil(n / S)`` rows (SPMD needs
uniform shapes); the tail beyond ``Length`` is padding and is kept ZERO as a
library-wide invariant.
"""
from __future__ import annotations


def shift(rank, align: int, stride: int):
    """First global index owned by ``rank``."""
    if stride == 1:
        return rank * 0
    return (rank - align) % stride


def owner(i, align: int, stride: int):
    """Rank owning global index ``i``."""
    if stride == 1:
        return i * 0
    return (i + align) % stride


def length(n: int, shft: int, stride: int) -> int:
    """Number of local entries for a rank with shift ``shft`` (static ints)."""
    if n <= shft:
        return 0
    return (n - shft + stride - 1) // stride


def max_local_length(n: int, stride: int) -> int:
    """ceil(n / stride): the uniform (padded) local extent all ranks store."""
    return -(-n // stride)


def padded_length(n: int, stride: int) -> int:
    """stride * ceil(n/stride): global extent after padding."""
    return stride * max_local_length(n, stride)
