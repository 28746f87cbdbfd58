"""Knob resolution policy: cache first, cost model second, explicit wins.

PyTorch port of ``elemental_tpu/tune/policy.py``.  A driver that receives
``'auto'`` for a knob calls :func:`resolve_knobs`; the resolver

  1. pins every knob the caller passed EXPLICITLY (an explicit value --
     including ``None``, the "driver default" sentinel -- always wins and
     simply constrains the candidate space),
  2. consults the persistent :mod:`.cache` for a measured winner under the
     ``(op, shape-bucket, dtype, grid, backend)`` key,
  3. otherwise scores the legal candidates with the analytic
     :mod:`.cost_model` (closed forms and a probe of the driver on a CPU
     grid of the same shape; nothing runs on the card, so ``'auto'``
     works cold on any machine) and picks the cheapest.

Resolutions are memoized in-process per (key, pinned knobs, cache dir),
and per raw request in front of that, so the hot path after the first
call is one dict lookup.  The canonical :func:`blocksize_policy` also
lives here -- the single grain-rounding / extent-clamping rule every
blocked driver shares.
"""
from __future__ import annotations

import dataclasses
import os

from . import cache as _cache
from .knobs import OPS, TuneContext, candidate_configs


# ---------------------------------------------------------------------
# the canonical blocksize policy (one rule, every driver)
# ---------------------------------------------------------------------

def blocksize_policy(nb, grain: int, extent: int) -> int:
    """Resolve an ``nb`` request to a legal block size: ``None`` reads the
    global :func:`~elemental_tpu_torch.core.environment.blocksize` stack,
    the result is rounded up to the distribution ``grain`` (views must
    start and end on stride boundaries) and clamped to the grain-rounded
    ``extent``.  ``'auto'`` must already have been resolved by
    :func:`resolve_knobs` -- reaching here with a string is a driver bug.
    """
    if isinstance(nb, str):
        raise TypeError(f"nb={nb!r} reached blocksize_policy unresolved; "
                        "drivers must route 'auto' through tune.resolve_knobs")
    from ..core.view import round_up
    if nb is None:
        from ..core.environment import blocksize
        nb = blocksize()
    nb = round_up(max(nb, 1), grain)
    return min(nb, round_up(max(extent, 1), grain))


# ---------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------

@dataclasses.dataclass
class Resolution:
    """The outcome of one knob resolution."""
    op: str
    key: _cache.CacheKey
    source: str                  # "cache" | "cost_model"
    config: dict                 # values for the knobs that were 'auto'
    requested: dict              # the original knob request
    scores: list | None = None   # CostBreakdowns (cost-model path only)

    def to_doc(self) -> dict:
        return {"op": self.op, "key": self.key.filename(),
                "source": self.source, "config": dict(self.config),
                "requested": {k: str(v) if isinstance(v, str) else v
                              for k, v in self.requested.items()}}


#: resolutions per (cache key, pinned knobs, cache dir), as the JAX
#: package memoizes them: requests of one shape bucket share an entry
_RESOLVE_MEMO: dict = {}
#: the same resolutions per raw request, looked up first
_REQUEST_MEMO: dict = {}


def clear_memo() -> None:
    """Drop the in-process resolution memo (tests swap cache dirs)."""
    _RESOLVE_MEMO.clear()
    _REQUEST_MEMO.clear()
    from . import cost_model
    cost_model.clear_trace_memo()


def is_auto(value) -> bool:
    return isinstance(value, str) and value == "auto"


def wants_auto(*values) -> bool:
    return any(is_auto(v) for v in values)


def dtype_name(dtype) -> str:
    """Canonical dtype name, the JAX package's words: ``torch.float32``,
    ``numpy.float32`` and ``'float32'`` all give ``'float32'``."""
    import numpy as np
    import torch
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


def _context(op: str, dims, dtype, grid) -> TuneContext:
    from ..redist.engine import backend_of
    return TuneContext(op=op, dims=tuple(int(d) for d in dims),
                       dtype=dtype_name(dtype),
                       grid_shape=(grid.height, grid.width),
                       backend=backend_of(grid))


def resolve(op: str, *, gshape, dtype, grid, requested: dict,
            machine=None) -> Resolution:
    """Resolve the ``'auto'`` knobs of one driver call.

    ``gshape`` is the op's dim tuple ((n, n), (m, n), or gemm's
    (m, k, n)); ``requested`` maps every tunable knob to its requested
    value -- ``'auto'`` entries get resolved, anything else is pinned.
    """
    # a repeated request is one dict lookup: no context, cache key or
    # directory path is built for it
    env = os.environ
    request_key = (op, tuple(gshape), dtype, grid.height, grid.width,
                   grid.device.type, tuple(requested.items()),
                   env.get(_cache.ENV_DIR), env.get("HOME"),
                   None if machine is None else machine.name)
    hit = _REQUEST_MEMO.get(request_key)
    if hit is not None:
        return hit
    spec = OPS.get(op)
    if spec is None:
        raise KeyError(f"unknown tunable op {op!r}; known: {sorted(OPS)}")
    ctx = _context(op, gshape, dtype, grid)
    auto_keys = tuple(k for k, v in requested.items() if is_auto(v))
    # non-'auto' values pin their knob -- INCLUDING None, the "driver
    # default" sentinel, so a user asking only alg='auto' never gets an
    # nb-assuming alg choice
    pinned = {k: v for k, v in requested.items() if not is_auto(v)}
    key = _cache.make_key(op, ctx.dims, ctx.dtype, ctx.grid_shape,
                          ctx.backend)
    memo_key = (key, tuple(sorted(pinned.items(), key=repr)), auto_keys,
                _cache.cache_dir(), None if machine is None else machine.name)
    hit = _RESOLVE_MEMO.get(memo_key)
    if hit is not None:
        _REQUEST_MEMO[request_key] = hit
        return hit

    res = None
    entry = _cache.load(key)
    if entry is not None:
        cfg = entry["config"]
        if all(k in cfg for k in auto_keys):
            res = Resolution(op=op, key=key, source="cache",
                             config={k: cfg[k] for k in auto_keys},
                             requested=dict(requested))
    if res is None:
        from . import cost_model
        cands = candidate_configs(ctx, pinned)
        if not cands:
            raise ValueError(f"no legal {op} configuration for {requested} "
                             f"at dims {ctx.dims} on grid {ctx.grid_shape}")
        scored = [cost_model.score_config(op, cfg, ctx=ctx, grid=grid,
                                          dtype=dtype, machine=machine)
                  for cfg in cands]
        # memory-pruned candidates sort behind every fitting one (an OOM
        # is not a slow configuration); all-pruned still resolves
        order = sorted(range(len(scored)),
                       key=lambda i: (scored[i].pruned,
                                      scored[i].total_s, i))
        best = scored[order[0]]
        res = Resolution(op=op, key=key, source="cost_model",
                         config={k: best.config[k] for k in auto_keys
                                 if k in best.config},
                         requested=dict(requested),
                         scores=[scored[i] for i in order])
    _RESOLVE_MEMO[memo_key] = _REQUEST_MEMO[request_key] = res
    return res


def resolve_knobs(op: str, *, gshape, dtype, grid, knobs: dict,
                  machine=None) -> dict:
    """Driver-facing wrapper: return ``knobs`` with every ``'auto'`` entry
    replaced by the resolved concrete value (other entries pass through
    unchanged -- explicit always wins)."""
    if not wants_auto(*knobs.values()):
        return dict(knobs)
    res = resolve(op, gshape=gshape, dtype=dtype, grid=grid, requested=knobs,
                  machine=machine)
    out = dict(knobs)
    for k in knobs:
        if is_auto(knobs[k]):
            out[k] = res.config.get(k)
    return out


#: the tuned ops that run on a device grid (every other driver that
#: resolves its knobs here refuses one)
DEVICE_GRID_OPS = frozenset({"cholesky", "trsm", "lu", "qr"})


def resolve_auto(op: str, gshape, dtype, grid, **knobs) -> dict:
    """:func:`resolve_knobs` with the knobs as keyword arguments, the one
    call every driver makes before anything else: the result holds them
    in the order given, each ``'auto'`` replaced by its resolution."""
    if getattr(grid, "devices", None) is not None:
        from ..core.ranks import DeviceGridError, refuse
        if op not in DEVICE_GRID_OPS:
            refuse(op)
        if wants_auto(*knobs.values()):
            raise DeviceGridError(f"{op}'s 'auto' knobs do not resolve on a "
                                  f"device grid yet (the tuner probes "
                                  f"virtual grids); pass explicit values")
    return resolve_knobs(op, gshape=gshape, dtype=dtype, grid=grid,
                         knobs=knobs)


def explain(op: str, *, gshape, dtype, grid, requested: dict | None = None,
            machine=None):
    """(context, scored candidates sorted best-first) for the ``explain``
    command: always runs the cost model (never the cache) so the
    breakdown reflects what a cold resolution would do."""
    from . import cost_model
    spec = OPS.get(op)
    if spec is None:
        raise KeyError(f"unknown tunable op {op!r}; known: {sorted(OPS)}")
    requested = requested or {k: "auto" for k in spec.knobs}
    ctx = _context(op, gshape, dtype, grid)
    pinned = {k: v for k, v in requested.items() if not is_auto(v)}
    cands = candidate_configs(ctx, pinned)
    scored = sorted((cost_model.score_config(op, cfg, ctx=ctx, grid=grid,
                                             dtype=dtype, machine=machine)
                     for cfg in cands),
                    key=lambda b: (b.pruned, b.total_s))
    return ctx, scored
