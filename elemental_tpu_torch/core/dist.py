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

The grid of the port is virtual (one device holds every rank's block), so
only the static layout math is needed here; the traced rank helpers of
the JAX package have no counterpart.
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
