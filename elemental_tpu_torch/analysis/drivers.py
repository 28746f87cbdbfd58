"""The driver registry and the recorded-run entry point.

The twin of the JAX package's ``analysis/drivers.py``: the same 33
registered drivers under the same names, the same geometry constants,
budget factors and comparison pairs.  Where the JAX package traces a
driver under ``jax.make_jaxpr`` on abstract inputs, the port RUNS it once
on seeded real inputs on a virtual r x c grid, inside
:func:`~..redist.engine.isolated_probe` (its own counters, trace and
collective log; no caller observer, fault plan or metric sees it), and
builds the :class:`~.plan.CommPlan` from what the engine recorded
(:mod:`.record_walk`).

``trace_driver(name, grid)`` returns ``(CommPlan, records, notes)``:
the plan, the engine's :class:`~..redist.engine.RedistRecord` log (the
JAX package's ``redist_log``) and the driver-level collective notes.
Inputs are float32 at n = 64, nb = 16 by default, as in the JAX registry.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..core import indexing as ix
from ..core.dist import MC, MR, STAR, MD, VC, CIRC, storage_slots, \
    stride as dist_stride
from ..core.distmatrix import DistMatrix, from_global
from ..redist import engine as _engine
from .plan import plan_from_parts
from .record_walk import collect_events

#: default trace geometry (four blocked steps at 64 / 16: look-ahead,
#: crossover and the SUMMA panel loops all take their real schedules)
DEFAULT_N = 64
DEFAULT_NB = 16
#: the explicit crossover of the *_crossover variants (the tail triggers
#: after two distributed steps at n = 64)
DEFAULT_XOVER = 32


def storage_shape(m: int, n: int, cdist, rdist, grid) -> tuple:
    """Stacked-storage shape of an (m, n) [cdist, rdist] DistMatrix."""
    r, c = grid.height, grid.width
    lr = ix.max_local_length(m, dist_stride(cdist, r, c))
    lc = ix.max_local_length(n, dist_stride(rdist, r, c))
    return (storage_slots(cdist, r, c) * lr, storage_slots(rdist, r, c) * lc)


def _mat(grid, m, n, dtype, kind="gen", seed=0) -> DistMatrix:
    """A seeded (m, n) [MC,MR] input made on the grid's device: general
    normal, HPD (G G^T / m + m I) or a well-conditioned lower triangle.
    The plans do not depend on the values; the forms keep every driver on
    its normal path."""
    dev = grid.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    F = torch.randn((m, n), generator=gen, device=dev, dtype=dt)
    eye = torch.eye(m, device=dev, dtype=dt)
    if kind == "hpd":
        F = F @ F.mT / m + m * eye
    elif kind == "tri":
        F = torch.tril(F) + m * eye
    return from_global(F, MC, MR, grid)


@dataclasses.dataclass(frozen=True)
class DriverSpec:
    """One registry entry: builds the callable, its inputs and its meta."""
    name: str
    build: callable          # (grid, n, nb, dtype) -> (fn, args, meta)
    allow_bf16: bool = False
    #: lint EL006 budget: peak live bytes may not exceed this multiple of
    #: the driver's per-device input + output residency
    mem_budget_factor: float = 4.0
    #: True when ``fn`` takes ``timer=`` (the phase hook of the drivers)
    timed: bool = False


def _gemm_spec(alg, variant="", redist_path=None):
    def build(grid, n, nb, dtype):
        from ..blas.level3 import gemm
        args = (_mat(grid, n, n, dtype),
                _mat(grid, n, n, dtype, seed=1))

        def fn(A, B):
            return gemm(A, B, alg=alg, nb=nb, redist_path=redist_path)
        meta = {"alg": alg}
        if redist_path is not None:
            meta["redist_path"] = redist_path
        return fn, args, meta
    name = f"gemm_{alg.lower()}"
    return DriverSpec(f"{name}_{variant}" if variant else name, build)


#: the slicing gemm's tall-skinny trace geometry, as multiples of ``n``:
#: (m, k, n') = (32 n, n, n / 4)
GEMM_SLICE_DIMS = (32, 1, 0.25)


def gemm_slice_extents(n: int) -> tuple:
    """(m, k, n') of the gemm_slice run at trace parameter ``n``."""
    sm, sk, sn = GEMM_SLICE_DIMS
    return int(sm * n), int(sk * n), max(int(sn * n), 1)


def _gemm_slice_spec():
    def build(grid, n, nb, dtype):
        from ..blas.level3 import gemm
        m, k, n2 = gemm_slice_extents(n)
        args = (_mat(grid, m, k, dtype),
                _mat(grid, k, n2, dtype, seed=1))

        def fn(A, B):
            return gemm(A, B, alg="slice", nb=nb)
        return fn, args, {"alg": "slice", "extents": [m, k, n2]}
    return DriverSpec("gemm_slice", build)


def _trsm_spec(variant="", side="L", redist_path=None):
    def build(grid, n, nb, dtype):
        from ..blas.level3 import trsm
        args = (_mat(grid, n, n, dtype, "tri"),
                _mat(grid, n, n, dtype, seed=1))

        def fn(A, B):
            return trsm(side, "L", "N", A, B, nb=nb, redist_path=redist_path)
        meta = {}
        if side != "L":
            meta["side"] = side
        if redist_path is not None:
            meta["redist_path"] = redist_path
        return fn, args, meta
    return DriverSpec(f"trsm_{variant}" if variant else "trsm", build)


def _herk_spec(variant="", redist_path=None):
    def build(grid, n, nb, dtype):
        from ..blas.level3 import herk

        def fn(A):
            return herk("L", A, nb=nb, redist_path=redist_path)
        meta = {}
        if redist_path is not None:
            meta["redist_path"] = redist_path
        return fn, (_mat(grid, n, n, dtype),), meta
    return DriverSpec(f"herk_{variant}" if variant else "herk", build)


def _lq_spec(variant="", redist_path=None):
    def build(grid, n, nb, dtype):
        from ..lapack.qr import lq

        def fn(A):
            return lq(A, nb=nb, redist_path=redist_path)
        meta = {}
        if redist_path is not None:
            meta["redist_path"] = redist_path
        return fn, (_mat(grid, n, n, dtype),), meta
    return DriverSpec(f"qr_lq_{variant}" if variant else "qr_lq", build)


def _redist_md_spec(variant="", redist_path=None):
    """[MC,MR] -> [MD,STAR] -> [STAR,MD] at ragged extents (n-1, n-3)."""
    def build(grid, n, nb, dtype):
        from ..redist.engine import redistribute
        m_, n_ = n - 1, n - 3

        def fn(A):
            B = redistribute(A, MD, STAR, path=redist_path)
            return redistribute(B, STAR, MD, path=redist_path)
        meta = {"extents": [m_, n_]}
        if redist_path is not None:
            meta["redist_path"] = redist_path
        return fn, (_mat(grid, m_, n_, dtype),), meta
    return DriverSpec(f"redist_md_{variant}" if variant else "redist_md",
                      build)


def _redist_circ_spec(variant=""):
    """[MC,MR] -> [CIRC,CIRC] -> [VC,STAR]: both root-only endpoints."""
    def build(grid, n, nb, dtype):
        from ..redist.engine import redistribute

        def fn(A):
            return redistribute(redistribute(A, CIRC, CIRC), VC, STAR)
        return fn, (_mat(grid, n, n, dtype),), {}
    return DriverSpec(f"redist_circ_{variant}" if variant
                      else "redist_circ", build)


#: the run-time panel-implementation override: the kernel-invariance
#: check re-runs every factorization variant with ``panel_impl`` forced
#: and byte-compares the plans.  A module global read inside the driver
#: callable, so the registry -- and every plan's meta -- is unchanged.
_PANEL_IMPL_OVERRIDE = None


def _panel_impl():
    return _PANEL_IMPL_OVERRIDE


@contextlib.contextmanager
def panel_impl_override(impl):
    """Run the factorization drivers with ``panel_impl=impl`` ('kernel'
    or 'torch') without touching their registered meta."""
    global _PANEL_IMPL_OVERRIDE
    prev = _PANEL_IMPL_OVERRIDE
    _PANEL_IMPL_OVERRIDE = impl
    try:
        yield
    finally:
        _PANEL_IMPL_OVERRIDE = prev


def _cholesky_spec(variant, lookahead, crossover, comm_precision=None,
                   abft=False):
    def build(grid, n, nb, dtype):
        from ..lapack.cholesky import cholesky

        def fn(A, timer=None):
            return cholesky(A, nb=nb, lookahead=lookahead,
                            crossover=crossover,
                            comm_precision=comm_precision,
                            abft=abft or None, panel_impl=_panel_impl(),
                            timer=timer)
        meta = {"lookahead": lookahead, "crossover": crossover,
                "comm_precision": comm_precision, "abft": abft}
        return fn, (_mat(grid, n, n, dtype, "hpd"),), meta
    return DriverSpec(f"cholesky_{variant}", build,
                      allow_bf16=comm_precision is not None, timed=True)


def _lu_spec(variant, lookahead, crossover, panel="classic",
             comm_precision=None, abft=False):
    def build(grid, n, nb, dtype):
        from ..lapack.lu import lu

        def fn(A, timer=None):
            return lu(A, nb=nb, lookahead=lookahead, crossover=crossover,
                      panel=panel, comm_precision=comm_precision,
                      abft=abft or None, panel_impl=_panel_impl(),
                      timer=timer)
        meta = {"lookahead": lookahead, "crossover": crossover,
                "panel": panel, "comm_precision": comm_precision,
                "abft": abft}
        return fn, (_mat(grid, n, n, dtype),), meta
    return DriverSpec(f"lu_{variant}", build,
                      allow_bf16=comm_precision is not None, timed=True)


def _qr_spec(variant="", panel="classic", abft=False):
    def build(grid, n, nb, dtype):
        from ..lapack.qr import qr

        def fn(A, timer=None):
            return qr(A, nb=nb, panel=panel, abft=abft or None,
                      panel_impl=_panel_impl(), timer=timer)
        # the abft key is conditional, as in the JAX registry
        meta = {"panel": panel, **({"abft": True} if abft else {})}
        return fn, (_mat(grid, n, n, dtype),), meta
    return DriverSpec(f"qr_{variant}" if variant else "qr", build,
                      timed=True)


#: per-driver EL006 budgets above the 4.0x default (the JAX registry's)
MEM_BUDGET_FACTORS = {
    "gemm_slice": 6.5,
    "gemm_dot_direct": 5.0,
    "herk_direct": 6.0,
    "qr_lq_direct": 5.0,
    "redist_circ": 6.5,
    "redist_md": 7.5,
    "redist_md_direct": 7.5,
}


def _registry() -> dict:
    specs = [
        _gemm_spec("A"), _gemm_spec("B"), _gemm_spec("C"),
        _gemm_spec("dot"), _gemm_spec("gspmd"), _gemm_slice_spec(),
        _trsm_spec(),
        _herk_spec(),
        _cholesky_spec("classic", lookahead=False, crossover=0),
        _cholesky_spec("lookahead", lookahead=True, crossover=0),
        _cholesky_spec("crossover", lookahead=True, crossover=DEFAULT_XOVER),
        _lu_spec("classic", lookahead=False, crossover=0),
        _lu_spec("lookahead", lookahead=True, crossover=0),
        _lu_spec("crossover", lookahead=True, crossover=DEFAULT_XOVER),
        _lu_spec("calu", lookahead=True, crossover=DEFAULT_XOVER,
                 panel="calu"),
        _qr_spec(),
        _qr_spec("tsqr", panel="tsqr"),
        _lu_spec("calu_commq", lookahead=True, crossover=DEFAULT_XOVER,
                 panel="calu", comm_precision="bf16"),
        _cholesky_spec("lookahead_commq", lookahead=True, crossover=0,
                       comm_precision="bf16"),
        _lu_spec("abft", lookahead=False, crossover=0, abft=True),
        _cholesky_spec("abft", lookahead=False, crossover=0, abft=True),
        _qr_spec("abft", abft=True),
        _gemm_spec("A", variant="direct", redist_path="direct"),
        _gemm_spec("B", variant="direct", redist_path="direct"),
        _gemm_spec("dot", variant="direct", redist_path="direct"),
        _lq_spec(),
        _lq_spec(variant="direct", redist_path="direct"),
        _trsm_spec(variant="r", side="R"),
        _trsm_spec(variant="r_direct", side="R", redist_path="direct"),
        _herk_spec(variant="direct", redist_path="direct"),
        _redist_md_spec(),
        _redist_md_spec(variant="direct", redist_path="direct"),
        _redist_circ_spec(),
    ]
    out = {}
    for s in specs:
        factor = MEM_BUDGET_FACTORS.get(s.name)
        if factor is not None:
            s = dataclasses.replace(s, mem_budget_factor=factor)
        out[s.name] = s
    return out


DRIVERS = _registry()

#: look-ahead / classic pairs whose all_gather rounds compare: the
#: default look-ahead configuration issues strictly fewer rounds
LOOKAHEAD_PAIRS = (
    ("cholesky_crossover", "cholesky_classic"),
    ("lu_crossover", "lu_classic"),
)

#: CALU issues strictly fewer collective rounds than both classic-panel
#: schedules at equal n / nb
CALU_PAIRS = (
    ("lu_calu", ("lu_classic", "lu_crossover")),
)

#: (quantized-wire variant, full-precision twin): equal round counts and
#: at least COMMQ_MIN_BYTE_RATIO x fewer wire bytes on 2x2
COMMQ_PAIRS = (
    ("lu_calu_commq", "lu_calu"),
    ("cholesky_lookahead_commq", "cholesky_lookahead"),
)
COMMQ_MIN_BYTE_RATIO = 1.9

#: (one-shot variant, chained twin): strictly fewer rounds on 2x2, no
#: collective at all on 1x1
DIRECT_PAIRS = (
    ("gemm_a_direct", "gemm_a"),
    ("gemm_b_direct", "gemm_b"),
    ("gemm_dot_direct", "gemm_dot"),
    ("qr_lq_direct", "qr_lq"),
    ("trsm_r_direct", "trsm_r"),
    ("herk_direct", "herk"),
)


def driver_names() -> list:
    return sorted(DRIVERS)


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _spec(name: str) -> DriverSpec:
    spec = DRIVERS.get(name)
    if spec is None:
        raise KeyError(f"unknown driver {name!r}; known: {driver_names()}")
    return spec


def build_driver(name: str, grid, n: int = DEFAULT_N, nb: int = DEFAULT_NB,
                 dtype=np.float32):
    """``(fn, args, meta)`` of a registered driver on ``grid``: the
    callable, its seeded inputs on the grid's device, and the plan meta
    (the JAX registry's keys)."""
    spec = _spec(name)
    fn, args, meta = spec.build(grid, n, nb, _dtype_name(dtype))
    full_meta = {"n": n, "nb": nb, "dtype": _dtype_name(dtype),
                 "input_dtypes": [_dtype_name(a.dtype) for a in args],
                 "allow_bf16": spec.allow_bf16}
    full_meta.update(meta)
    return fn, args, full_meta


def trace_driver(name: str, grid, n: int = DEFAULT_N, nb: int = DEFAULT_NB,
                 dtype=np.float32):
    """Run a registered driver once on ``grid`` (a port :class:`Grid`;
    its device decides where) and return ``(CommPlan, records, notes)``."""
    fn, args, meta = build_driver(name, grid, n, nb, dtype)
    with _engine.isolated_probe() as (records, notes):
        fn(*args)
    records, notes = list(records), list(notes)
    events = collect_events(records, notes)
    plan = plan_from_parts(name, (grid.height, grid.width), meta, events,
                           records)
    return plan, records, notes


def trace_callable(fn, args, name: str = "custom", grid=None, meta=None):
    """Run an arbitrary driver callable once on ``args`` (tensors or
    DistMatrices) and return ``(CommPlan, records, notes)``; used by the
    tests and the lint's seeded regressions."""
    with _engine.isolated_probe() as (records, notes):
        fn(*args)
    records, notes = list(records), list(notes)
    events = collect_events(records, notes)
    gshape = (grid.height, grid.width) if grid is not None else (0, 0)
    full_meta = {"input_dtypes": [_dtype_name(a.dtype) for a in args]}
    full_meta.update(meta or {})
    plan = plan_from_parts(name, gshape, full_meta, events, records)
    return plan, records, notes
