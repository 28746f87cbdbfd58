"""Distribution taxonomy.

PyTorch port of ``elemental_tpu/core/dist.py``: the reference's
``enum Dist {MC, MD, MR, VC, VR, STAR, CIRC}`` (Elemental
``include/El/core/types.hpp``) and its 13 legal (ColDist, RowDist) pairs,
over an r x c grid (p = r*c):

  MC    -- distributed over the grid's columns of ranks, stride r
  MR    -- distributed over the grid's rows of ranks, stride c
  VC    -- 1-D cyclic over all p ranks, column-major rank  q = mc + r*mr
  VR    -- 1-D cyclic over all p ranks, row-major rank     q = mr + c*mc
  STAR  -- replicated
  MD    -- matrix diagonal distribution: entry k on rank (k%r, k%c),
           stride lcm(r, c); the storage stacks p slot-ranges (mc-major)
           of length ceil(n/lcm), ranks outside the diagonal comm hold
           zeros
  CIRC  -- all data on the root: the storage is the full array

The static layout math serves both kinds of grid.  The JAX package's
rank helpers (:func:`gather_axes`, :func:`spec_component`,
:func:`rank_of`) read traced axis indices inside ``shard_map``; here a
device grid runs each rank's step on the host with the rank's ``(mc,
mr)`` known, so they take and return plain integers.
"""
from __future__ import annotations

import enum
import math

import numpy as np


class Dist(enum.Enum):
    MC = "MC"
    MD = "MD"
    MR = "MR"
    VC = "VC"
    VR = "VR"
    STAR = "STAR"
    CIRC = "CIRC"

    def __repr__(self):  # compact in error messages
        return self.value


MC, MD, MR, VC, VR, STAR, CIRC = (
    Dist.MC, Dist.MD, Dist.MR, Dist.VC, Dist.VR, Dist.STAR, Dist.CIRC,
)

#: The legal (ColDist, RowDist) pairs -- the reference's 13 plus [CIRC,CIRC].
LEGAL_PAIRS = (
    (MC, MR), (MC, STAR), (STAR, MR),
    (MR, MC), (MR, STAR), (STAR, MC),
    (VC, STAR), (STAR, VC),
    (VR, STAR), (STAR, VR),
    (MD, STAR), (STAR, MD),
    (STAR, STAR),
    (CIRC, CIRC),
)


def stride(d: Dist, r: int, c: int) -> int:
    """Number of ranks the dimension is split over (index-math stride)."""
    if d is Dist.MC:
        return r
    if d is Dist.MR:
        return c
    if d in (Dist.VC, Dist.VR):
        return r * c
    if d is Dist.MD:
        return r * c // math.gcd(r, c)      # lcm(r, c)
    # STAR replicated; CIRC root-only
    return 1


def storage_slots(d: Dist, r: int, c: int) -> int:
    """Slot count of the stacked-storage dimension.  Equals the stride for
    every cyclic layout; MD stacks p slot-ranges (mc-major) even though
    its stride is lcm(r, c), because its owner map (k%r, k%c) is not a
    nested axis order -- ranks outside the diagonal comm hold zeros."""
    if d is Dist.MD:
        return r * c
    return stride(d, r, c)


def md_params(r: int, c: int):
    """(gcd, lcm, inv) with inv = (r/gcd)^{-1} mod (c/gcd): the static CRT
    data for the MD owner map.  Rank (i, j) owns diagonal entries
    k = k0 + t*lcm with k0 = i + r * (((j - i)//g * inv) % (c//g)),
    defined only when (i - j) % g == 0."""
    g = math.gcd(r, c)
    cg = c // g
    inv = pow((r // g) % cg, -1, cg) if cg > 1 else 0
    return g, r * c // g, inv


def md_slot_of_global(r: int, c: int, n: int):
    """Static numpy map: global index k -> flat storage slot
    (mc-major rank id (k%r)*c + (k%c), local offset k // lcm)."""
    _, L, _ = md_params(r, c)
    l = -(-n // L) if n else 1
    k = np.arange(n)
    return ((k % r) * c + (k % c)) * l + k // L


def gather_axes(d: Dist) -> tuple:
    """Grid axes (major first) whose all_gather rebuilds a ``d``-split
    dimension in rank order ('mc' = the grid's height, 'mr' its width);
    MD's slot ranges gather mc-major."""
    return {Dist.MC: ("mc",), Dist.MR: ("mr",), Dist.VC: ("mr", "mc"),
            Dist.VR: ("mc", "mr"), Dist.MD: ("mc", "mr")}.get(d, ())


def spec_component(d: Dist):
    """The grid axes a ``d`` dimension of the stacked storage is split
    over (the JAX ``PartitionSpec`` entry; ``None`` = not split)."""
    return {Dist.MC: "mc", Dist.MR: "mr", Dist.VC: ("mr", "mc"),
            Dist.VR: ("mc", "mr"), Dist.MD: ("mc", "mr")}.get(d)


def rank_of(d: Dist, r: int, c: int, mc: int, mr: int) -> int:
    """Rank ``(mc, mr)``'s rank within distribution ``d``.

    For MD the "rank" is k0, the first diagonal entry the rank owns
    (< lcm), or the out-of-range sentinel lcm for a rank outside the
    diagonal comm."""
    if d is Dist.MC:
        return mc
    if d is Dist.MR:
        return mr
    if d is Dist.VC:
        return mc + r * mr
    if d is Dist.VR:
        return mr + c * mc
    if d is Dist.MD:
        g, L, inv = md_params(r, c)
        if (mc - mr) % g:
            return L
        return (mc + r * ((((mr - mc) // g) * inv) % (c // g))) % L
    return 0


def storage_slot(d: Dist, r: int, c: int, mc: int, mr: int) -> int:
    """The slot of the stacked storage's ``d`` dimension that rank ``(mc,
    mr)`` holds (0 for a replicated dimension; MD's mc-major slot
    range)."""
    if d is Dist.MD:
        return mc * c + mr
    if d in (Dist.STAR, Dist.CIRC):
        return 0
    return rank_of(d, r, c, mc, mr)
