"""Process grids: the virtual grid on one device, and the device grid.

PyTorch port of ``elemental_tpu/core/grid.py``.  The reference's
``El::Grid`` splits an MPI communicator into an r x c grid; the JAX
package backs it with a device ``Mesh``.  The port has two kinds:

* the VIRTUAL grid, ``Grid(r, c, device=...)``: every rank's local block
  lives in the one stacked-storage tensor on ``grid.device``, so an
  r x c layout is pure index math and a redistribution is an index
  permutation on that device.  One H100 is the 1 x 1 grid, the default.
* the DEVICE grid, ``Grid(r, c, devices=[...])``: rank ``(mc, mr)`` holds
  its own local block on ``devices[mc * c + mr]`` (the JAX
  ``np.asarray(devices).reshape(r, c)``), and a redistribution runs the
  JAX engine's collectives as copies between the ranks' blocks
  (:mod:`.ranks`).  One process drives every rank; ranks may share a
  device (``["cpu"] * 4``, ``["cuda:0"] * 4``).

The default device is ``cuda:0``.  A caller that wants the CPU asks for it
(``Grid(device="cpu")``); nothing falls back to the CPU when there is no
card -- allocating on ``cuda`` then simply fails, and a device grid that
names a CUDA device the machine has not got raises at construction.
"""
from __future__ import annotations

import math

import torch


def _near_square_height(p: int) -> int:
    r = int(math.isqrt(p))
    while p % r != 0:
        r -= 1
    return r


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def _check_present(devs: tuple) -> None:
    types = {d.type for d in devs}
    if len(types) != 1:
        raise ValueError(f"a device grid's devices are of one type, got "
                         f"{sorted(types)}")
    if types == {"cuda"}:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        missing = sorted({d.index for d in devs if d.index >= have})
        if missing:
            raise RuntimeError(f"device grid names cuda:{missing}, but this "
                               f"machine has {have} CUDA device(s)")
    elif types != {"cpu"}:
        raise ValueError(f"a device grid runs on cpu or cuda devices, got "
                         f"{sorted(types)}")


class Grid:
    """An r x c grid: virtual on one ``torch.device``, or with ``devices``
    a device grid whose rank ``(mc, mr)`` sits on ``devices[mc*c + mr]``."""

    def __init__(self, height: int | None = None, width: int | None = None,
                 device=None, *, devices=None):
        if devices is not None:
            if device is not None:
                raise ValueError("give a grid either device= (virtual) or "
                                 "devices= (one per rank), not both")
            devs = tuple(_device(d) for d in devices)
            p = len(devs)
            if p == 0:
                raise ValueError("a device grid needs at least one device")
            if height is None:
                r = p // int(width) if width is not None \
                    else _near_square_height(p)
            else:
                r = int(height)
            if r < 1 or p % r != 0:
                raise ValueError(f"grid height {r} does not divide device "
                                 f"count {p}")
            c = p // r
            if width is not None and int(width) != c:
                raise ValueError(f"a {r}x{width} grid needs {r * int(width)} "
                                 f"devices, got {p}")
            _check_present(devs)
            self._r, self._c = r, c
            self.devices = devs
            self.device = devs[0]        # the root rank's device
            return
        r = 1 if height is None else int(height)
        c = 1 if width is None else int(width)
        if r < 1 or c < 1:
            raise ValueError(f"grid shape must be positive, got {r}x{c}")
        self._r, self._c = r, c
        self.devices = None
        self.device = _device("cuda:0" if device is None else device)

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
        return (self._r, self._c, self.device, self.devices)

    def __eq__(self, other):
        return isinstance(other, Grid) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        if self.devices is not None:
            return (f"Grid({self._r}x{self._c}, devices="
                    f"[{', '.join(str(d) for d in self.devices)}])")
        return f"Grid({self._r}x{self._c}, {self.device})"


_default_grid: Grid | None = None


def default_grid() -> Grid:
    """Lazily-built virtual 1x1 grid on ``cuda:0`` (``Grid::Default()``)."""
    global _default_grid
    if _default_grid is None:
        _default_grid = Grid()
    return _default_grid


def set_default_grid(g: Grid) -> None:
    """Replace the grid :func:`default_grid` returns."""
    global _default_grid
    _default_grid = g
