"""Positive-orthant cone utilities + IPM control structs.

PyTorch port of ``elemental_tpu/optimization/util.py`` (Elemental
``src/optimization/util/PosOrth/**``: ``MaxStep``, ``NumOutside``, and the
``MehrotraCtrl`` tuning struct of ``include/El/optimization/solvers.hpp``).

Vectors are (k, 1) [MC,MR] DistMatrices; elementwise cone ops run directly
on storage tensors (each entry exactly once, padding zero -- guarded where
a zero denominator could poison the result).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.distmatrix import DistMatrix


@dataclasses.dataclass(frozen=True)
class MehrotraCtrl:
    """Tolerances/switches for the Mehrotra predictor-corrector IPMs
    (``El::MehrotraCtrl``)."""
    tol: float = 1e-8
    max_iters: int = 100
    eta: float = 0.995          # fraction-to-the-boundary damping
    init_shift: float = 10.0    # Mehrotra initialization delta scaling
    print_progress: bool = False
    equilibrate: bool = True    # Ruiz-equilibrate the data first
                                # (El::RuizEquil, upstream's mandatory step)


def safe_div(a, b):
    """a / b with 0/0 -> 0 (padding-safe elementwise divide)."""
    return torch.where(b != 0, a / torch.where(b == 0, 1, b), 0)


def max_step(x: DistMatrix, dx: DistMatrix, cap: float = 1.0):
    """sup {alpha <= cap : x + alpha dx >= 0} for interior x > 0
    (``El::pos_orth::MaxStep``).  Returns a 0-d tensor on the device."""
    ratio = torch.where(dx.local < 0, -safe_div(x.local, dx.local),
                        torch.inf)
    return torch.clamp(torch.min(ratio), max=cap)


def num_outside(x: DistMatrix):
    """Entries strictly outside the cone (``pos_orth::NumOutside``);
    padding zeros count as on the boundary, not outside."""
    return torch.sum(x.local < 0)
