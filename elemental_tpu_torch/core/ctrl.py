"""Ctrl dataclasses: the per-call tuning-struct system.

Reference: Elemental's dominant configuration pattern (SURVEY.md §6.6) --
plain structs of tolerances/switches threaded explicitly through calls:
``QRCtrl``, ``LDLPivotCtrl``, ``HermitianEigCtrl``, ``SVDCtrl``,
``SchurCtrl``/``SDCCtrl``, ``SignCtrl``, ``PseudospecCtrl``,
``LeastSquaresCtrl`` (``MehrotraCtrl`` lives in ``optimization``).

PyTorch port of ``elemental_tpu/core/ctrl.py``, verbatim: every Ctrl is
a FROZEN dataclass, hence hashable.  Each maps 1:1 onto the keyword
arguments of the corresponding driver; ``ctrl.kwargs()`` expands it so
``f(A, **ctrl.kwargs())`` is the explicit-threading idiom.  Fields left at
None defer to the callee's defaults (e.g. ``nb=None`` -> the environment
blocksize stack).
"""
from __future__ import annotations

from dataclasses import dataclass, fields


class _Ctrl:
    def kwargs(self) -> dict:
        """Expand into keyword arguments, dropping None-valued fields."""
        return {f.name: getattr(self, f.name) for f in fields(self)
                if getattr(self, f.name) is not None}


@dataclass(frozen=True)
class SignCtrl(_Ctrl):
    """Newton sign-iteration knobs (``El::SignCtrl``)."""
    maxiter: int = 40
    tol: float | None = None
    nb: int | None = None


@dataclass(frozen=True)
class PolarCtrl(_Ctrl):
    """QDWH polar knobs (``El::PolarCtrl``)."""
    nb: int | None = None


@dataclass(frozen=True)
class HermitianEigCtrl(_Ctrl):
    """``El::HermitianEigCtrl``: approach = 'auto' | 'tridiag' | 'qdwh'."""
    vectors: bool = True
    approach: str = "auto"
    subset: tuple | None = None
    nb: int | None = None


@dataclass(frozen=True)
class SVDCtrl(_Ctrl):
    """``El::SVDCtrl``: approach = 'auto' | 'chan' | 'polar' | 'golub' |
    'local'."""
    vectors: bool = True
    approach: str = "auto"
    nb: int | None = None


@dataclass(frozen=True)
class SchurCtrl(_Ctrl):
    """Spectral divide-and-conquer knobs (``El::SchurCtrl``/``SDCCtrl``)."""
    base: int | None = None
    nb: int | None = None


@dataclass(frozen=True)
class PseudospecCtrl(_Ctrl):
    """``El::PseudospecCtrl``: window resolution + power-iteration count."""
    nx: int = 20
    ny: int = 20
    iters: int = 30
    nb: int | None = None


@dataclass(frozen=True)
class LDLPivotCtrl(_Ctrl):
    """``El::LDLPivotCtrl``: Bunch-Kaufman is the only pivot type."""
    conjugate: bool | None = None
    nb: int | None = None


@dataclass(frozen=True)
class QRCtrl(_Ctrl):
    """``El::QRCtrl`` (col-pivoting selected by calling ``qr_col_piv``)."""
    nb: int | None = None


@dataclass(frozen=True)
class LeastSquaresCtrl(_Ctrl):
    """``El::LeastSquaresCtrl``."""
    nb: int | None = None
