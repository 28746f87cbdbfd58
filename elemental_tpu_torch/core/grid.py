"""A virtual process grid held in one process on one device.

PyTorch port of ``elemental_tpu/core/grid.py``.  The reference's
``El::Grid`` splits an MPI communicator into an r x c grid; the JAX
package backs it with a device ``Mesh``.  Here the grid is VIRTUAL: every
rank's local block lives in the one stacked-storage tensor on
``grid.device``, so an r x c layout is pure index math and a
redistribution is an index permutation on that device.  One H100 is the
1 x 1 grid, the default.

The default device is ``cuda:0``.  A caller that wants the CPU asks for it
(``Grid(device="cpu")``); nothing falls back to the CPU when there is no
card -- allocating on ``cuda`` then simply fails.
"""
from __future__ import annotations

import math

import torch


class Grid:
    """An r x c virtual grid on one ``torch.device``."""

    def __init__(self, height: int | None = None, width: int | None = None,
                 device=None):
        r = 1 if height is None else int(height)
        c = 1 if width is None else int(width)
        if r < 1 or c < 1:
            raise ValueError(f"grid shape must be positive, got {r}x{c}")
        dev = torch.device("cuda:0" if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        self._r, self._c = r, c
        self.device = dev

    @property
    def height(self) -> int:  # r == |MC|
        return self._r

    @property
    def width(self) -> int:   # c == |MR|
        return self._c

    @property
    def size(self) -> int:    # p
        return self._r * self._c

    @property
    def lcm(self) -> int:     # MD stride in the reference
        return self._r * self._c // math.gcd(self._r, self._c)

    def _key(self):
        return (self._r, self._c, self.device)

    def __eq__(self, other):
        return isinstance(other, Grid) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"Grid({self._r}x{self._c}, {self.device})"


_default_grid: Grid | None = None


def default_grid() -> Grid:
    """Lazily-built 1x1 grid on ``cuda:0`` (``Grid::Default()``)."""
    global _default_grid
    if _default_grid is None:
        _default_grid = Grid()
    return _default_grid


def set_default_grid(g: Grid) -> None:
    """Replace the grid :func:`default_grid` returns."""
    global _default_grid
    _default_grid = g
