"""Per-rank steps and collectives of a device grid.

The port's counterpart of ``elemental_tpu/core/compat.py``'s ``shard_map``
and of the ``lax`` collectives the JAX engine calls inside it.  On a
device grid (:class:`~.grid.Grid` with ``devices=``) a DistMatrix's
``local`` is a :class:`Tiles`: rank ``d = mc * c + mr``'s local block on
``grid.devices[d]``.  One Python process drives every rank:

* :func:`per_rank` runs a step once per rank on that rank's blocks (under
  ``torch.cuda.device`` for a CUDA device) -- the body of a
  ``shard_map``;
* :func:`all_gather`, :func:`all_to_all`, :func:`ppermute` and
  :func:`psum` are the collectives, over the same named axes and in the
  same rank order as ``lax.all_gather`` / ``all_to_all`` / ``ppermute`` /
  ``psum`` on the JAX mesh (``'mc'`` = the grid's height, ``'mr'`` its
  width); :func:`gather_rows` is the row motion within a grid column
  that GSPMD plans for the JAX engine's storage gathers (``move_rows``,
  ``permute_rows_storage``).  Every value that one rank hands another is
  one ``copy_`` from the sender's tensor into the receiver's, and goes
  through the byte tally (:func:`tally`).

Ranks that share a device run one after the other on that device's
current stream.

On a virtual grid :func:`per_rank` runs the step ONCE, on the stacked
storage (every rank's block at once, ``rank=None``): the same step
serves both grids wherever it is a per-block operation (a product of
conforming storage, a mask, an elementwise update).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import sys

import torch


class DeviceGridError(NotImplementedError):
    """An operation that does not run on a device grid yet."""


#: what runs on a device grid (the error message names it)
SUPPORTED = ("from_global", "to_global", "zeros", "from_storage",
             "storage_numpy", "view", "update_view", "pad_matrix",
             "redistribute", "panel_spread", "transpose_dist",
             "make_trapezoidal", "cholesky", "hpd_solve",
             "cholesky_solve_after", "trsm", "move_rows",
             "permute_rows_storage", "interior_view", "permute_rows",
             "lu (classic and calu panels)", "lu_solve", "lu_solve_after",
             "qr (classic panel)", "apply_q", "least_squares")


def refuse(what: str):
    """Raise the one error of everything that does not run on a device
    grid yet."""
    raise DeviceGridError(
        f"{what} does not run on a device grid yet; a device grid runs "
        f"{', '.join(SUPPORTED)} (the other drivers are later slices of "
        f"the port, see ROADMAP.md)")


def is_device_grid(grid) -> bool:
    return getattr(grid, "devices", None) is not None


def caller_name(depth: int = 2) -> str:
    """The name of the function ``depth`` frames up (the driver whose
    entry check refuses a device grid)."""
    return sys._getframe(depth).f_code.co_name


def tensors(*objs) -> tuple:
    """The tensors behind DistMatrix / Tiles / tensor arguments (every
    rank's tile of a device grid's matrix)."""
    out = []
    for o in objs:
        loc = getattr(o, "local", o)
        out.extend(loc.tiles if isinstance(loc, Tiles) else (loc,))
    return tuple(out)


class Tiles:
    """Every rank's local block of a DistMatrix on a device grid, in rank
    order ``d = mc * c + mr``, each on its rank's device.

    Not a tensor: code that treats it as one fails.  ``tiles[d]`` is
    rank d's tensor; ``dtype`` the blocks' dtype."""
    __slots__ = ("grid", "tiles")

    def __init__(self, grid, tiles):
        tiles = tuple(tiles)
        if len(tiles) != grid.size:
            raise ValueError(f"{len(tiles)} tiles for a {grid.height}x"
                             f"{grid.width} grid")
        self.grid = grid
        self.tiles = tiles

    @property
    def dtype(self):
        return self.tiles[0].dtype

    def __len__(self):
        return len(self.tiles)

    def __iter__(self):
        return iter(self.tiles)

    def __getitem__(self, d):
        if not isinstance(d, int):
            raise TypeError(f"Tiles are indexed by rank, got {d!r}: a device "
                            f"grid's local blocks are not one tensor")
        return self.tiles[d]

    def __repr__(self):
        shapes = sorted({tuple(t.shape) for t in self.tiles})
        return (f"Tiles({self.grid.height}x{self.grid.width}, {self.dtype}, "
                f"shapes={shapes})")


def _per_rank_of(a):
    """``a``'s Tiles when it holds one (a Tiles, or a DistMatrix-like
    object whose ``local`` is one), else None."""
    if isinstance(a, Tiles):
        return a
    loc = getattr(a, "local", None)
    return loc if isinstance(loc, Tiles) else None


def _plain(a):
    """A virtual-grid argument as the step sees it: a DistMatrix-like
    object gives its storage tensor."""
    return a.local if hasattr(a, "local") and hasattr(a, "gshape") else a


def device_context(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def per_rank(fn, *args):
    """Run ``fn(rank, *blocks)`` once per rank of a device grid, ``rank``
    = ``(mc, mr)``, ``blocks`` the rank's tile of each Tiles (or
    DistMatrix) argument and every other argument as given, under the
    rank's CUDA device.  Returns the ranks' results as a Tiles (a tuple
    of Tiles when ``fn`` returns a tuple).

    With no per-rank argument (a virtual grid) ``fn(None, *args)`` runs
    once on the stacked storage and its result is returned as is."""
    tiles = [_per_rank_of(a) for a in args]
    lead = next((t for t in tiles if t is not None), None)
    if lead is None:
        return fn(None, *(_plain(a) for a in args))
    g = lead.grid
    c = g.width
    outs = []
    for d, dev in enumerate(g.devices):
        blocks = [t.tiles[d] if t is not None else a
                  for t, a in zip(tiles, args)]
        with device_context(dev):
            outs.append(fn((d // c, d % c), *blocks))
    if isinstance(outs[0], tuple):
        return tuple(Tiles(g, col) for col in zip(*outs))
    return Tiles(g, outs)


def rank_map(grid, fn) -> Tiles:
    """``fn(rank, device)`` for every rank of a device grid, as a Tiles
    (a step with no per-rank input, e.g. allocating each rank's block)."""
    c = grid.width
    outs = []
    for d, dev in enumerate(grid.devices):
        with device_context(dev):
            outs.append(fn((d // c, d % c), dev))
    return Tiles(grid, outs)


# ---------------------------------------------------------------------
# the byte tally
# ---------------------------------------------------------------------

@dataclasses.dataclass
class Tally:
    """Bytes and copies moved between distinct ranks by the collectives."""
    bytes: int = 0
    copies: int = 0


#: the tally the collectives count into (None: not counting)
_TALLY: Tally | None = None


@contextlib.contextmanager
def tally():
    """Count the bytes and copies the collectives move between distinct
    ranks inside the block into a fresh :class:`Tally` (yielded); the
    enclosing tally, if any, is restored on exit."""
    global _TALLY
    prev = _TALLY
    _TALLY = Tally()
    try:
        yield _TALLY
    finally:
        _TALLY = prev


def _send(dst: torch.Tensor, src: torch.Tensor, d_src: int,
          d_dst: int) -> None:
    """Rank ``d_src`` hands ``src`` to rank ``d_dst``, landing in
    ``dst``."""
    dst.copy_(src)
    if d_src != d_dst and _TALLY is not None:
        _TALLY.bytes += src.numel() * src.element_size()
        _TALLY.copies += 1


# ---------------------------------------------------------------------
# collectives over named grid axes
# ---------------------------------------------------------------------

def _coords(d: int, c: int) -> dict:
    return {"mc": d // c, "mr": d % c}


def group(axes, d: int, r: int, c: int) -> list:
    """The ranks that share rank ``d``'s coordinates off ``axes``, in the
    linear order of ``axes`` (first name major): the participants of a
    collective over ``axes``, as the JAX mesh orders them."""
    if isinstance(axes, str):
        axes = (axes,)
    sizes = {"mc": r, "mr": c}
    out = []
    for idx in itertools.product(*(range(sizes[a]) for a in axes)):
        m = _coords(d, c) | dict(zip(axes, idx))
        out.append(m["mc"] * c + m["mr"])
    return out


def all_gather(xs: Tiles, axes) -> Tiles:
    """``lax.all_gather(x, axes, axis=0)`` on every rank: each gets the
    (S, *block) stack of its group's blocks in the axes' rank order."""
    g = xs.grid
    r, c = g.height, g.width
    outs = []
    for d, dev in enumerate(g.devices):
        members = group(axes, d, r, c)
        x = xs.tiles[d]
        out = torch.empty((len(members),) + tuple(x.shape), dtype=x.dtype,
                          device=dev)
        for k, s in enumerate(members):
            _send(out[k], xs.tiles[s], s, d)
        outs.append(out)
    return Tiles(g, outs)


def all_to_all(xs: Tiles, axis: str, split_axis: int,
               concat_axis: int) -> Tiles:
    """``lax.all_to_all(x, axis, split_axis, concat_axis)``: the member at
    position b of a rank's group sends chunk a (the rank's position) of
    its ``split_axis``, which lands as chunk b of the rank's
    ``concat_axis``."""
    g = xs.grid
    r, c = g.height, g.width
    outs = []
    for d, dev in enumerate(g.devices):
        members = group(axis, d, r, c)
        S = len(members)
        a = members.index(d)
        x = xs.tiles[d]
        if x.shape[split_axis] % S:
            raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)}"
                             f" does not split {S} ways")
        sz = x.shape[split_axis] // S
        shape = list(x.shape)
        shape[split_axis] = sz
        shape[concat_axis] = shape[concat_axis] * S
        out = torch.empty(shape, dtype=x.dtype, device=dev)
        for b, s in enumerate(members):
            chunk = xs.tiles[s].narrow(split_axis, a * sz, sz)
            csz = chunk.shape[concat_axis]
            _send(out.narrow(concat_axis, b * csz, csz), chunk, s, d)
        outs.append(out)
    return Tiles(g, outs)


def ppermute(xs: Tiles, axes, perm) -> Tiles:
    """``lax.ppermute(x, axes, perm)``: ``perm`` holds (source, target)
    pairs of linear indices within each group over ``axes`` (for
    ``('mc', 'mr')`` the linear index is ``mc * c + mr``); a rank that no
    pair targets gets zeros."""
    g = xs.grid
    r, c = g.height, g.width
    src_of = {t: s for s, t in perm}
    outs = []
    for d, dev in enumerate(g.devices):
        members = group(axes, d, r, c)
        out = torch.zeros_like(xs.tiles[d], device=dev)
        s = src_of.get(members.index(d))
        if s is not None:
            _send(out, xs.tiles[members[s]], members[s], d)
        outs.append(out)
    return Tiles(g, outs)


def psum(xs: Tiles, axes, acc_dtype=None) -> Tiles:
    """``lax.psum(x, axes)``: each rank gets the sum of its group's blocks
    (:func:`group`), added in the group's rank order on the rank's own
    device, so every member gets the same bits.  ``acc_dtype`` is the
    dtype the sum runs in (default the blocks'); the payload moves in the
    blocks' own dtype.

    Tally: every rank receives the blocks of the S - 1 other members of
    its group, so a call moves p (S - 1) x ``block bytes``."""
    g = xs.grid
    r, c = g.height, g.width
    outs = []
    for d, dev in enumerate(g.devices):
        members = group(axes, d, r, c)
        x = xs.tiles[d]
        recv = torch.empty((len(members),) + tuple(x.shape), dtype=x.dtype,
                           device=dev)
        for k, s in enumerate(members):
            _send(recv[k], xs.tiles[s], s, d)
        acc = recv[0].to(acc_dtype or x.dtype, copy=True)
        for k in range(1, len(members)):
            acc += recv[k]
        outs.append(acc)
    return Tiles(g, outs)


def gather_rows(xs: Tiles, sources: Tiles) -> Tiles:
    """Row motion within each grid column of a zero-aligned [MC,*] matrix,
    whose rank (mc, mr) holds global rows ``mc + r * iLoc``: each rank gets
    the (k, local width) block of the global rows its own copy of
    ``sources`` lists (k entries, each a row of the matrix).

    No host sync learns which rows cross ranks: every rank of the column
    offers a buffer of a fixed b = min(k, local rows) rows, an
    ``all_gather`` over ``'mc'`` spreads the buffers, and each rank picks
    row j from the buffer of the member that owns ``sources[j]`` (member
    ``sources[j] % r``).  With k < local rows a member's buffer holds the
    rows ``sources // r`` of its tile (the entries it does not own are
    never picked); otherwise the buffer is its whole tile.  Rows never
    change grid column, so nothing moves over ``'mr'``.

    Tally: every rank receives r - 1 buffers, so a call moves p (r - 1) b
    (local width) (itemsize) bytes between ranks."""
    g = xs.grid
    r = g.height
    lr = xs.tiles[0].shape[0]
    k = sources.tiles[0].shape[0]
    whole = k >= lr

    def offer(rk, x, src):
        return x if whole else x.index_select(0, src // r)

    bufs = all_gather(per_rank(offer, xs, sources), "mc")

    def pick(rk, buf, src):
        slot = src // r if whole else torch.arange(k, device=src.device)
        return buf.reshape(-1, buf.shape[-1]).index_select(
            0, (src % r) * buf.shape[1] + slot)

    return per_rank(pick, bufs, sources)


def broadcast(xs: Tiles, root: int = 0) -> Tiles:
    """Every rank gets a copy of rank ``root``'s block."""
    g = xs.grid
    x = xs.tiles[root]
    outs = []
    for d, dev in enumerate(g.devices):
        out = torch.empty(tuple(x.shape), dtype=x.dtype, device=dev)
        _send(out, x, root, d)
        outs.append(out)
    return Tiles(g, outs)


def replicate(grid, x) -> Tiles:
    """Every rank's copy of ``x``: a Tiles as given, else ``x`` (a tensor
    or host data) placed on the root rank's device and handed to the
    others by a tallied :func:`broadcast`."""
    if isinstance(x, Tiles):
        return x
    t = torch.as_tensor(x, device=grid.devices[0])
    return broadcast(Tiles(grid, [t] * grid.size))


def synchronize(grid) -> None:
    """Wait for every CUDA device of a device grid."""
    for dev in sorted({d for d in grid.devices if d.type == "cuda"},
                      key=lambda d: d.index):
        torch.cuda.synchronize(dev)
