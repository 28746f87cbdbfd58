"""Numerical-health guards: cheap per-phase checks -> ``health_report/v1``.

PyTorch port of ``elemental_tpu/resilience/health.py``.  A
:class:`HealthMonitor` speaks the tick protocol (``start()`` +
``tick(phase, step, *arrays)``), so it rides the drivers' hook seam:
``lu(..., health=...)`` / ``cholesky(..., health=...)`` /
``qr(..., health=...)`` fan the monitor into the phase hook, and every
phase boundary the driver already ticks becomes a checkpoint.  With
``health=None`` (the default) NOTHING is attached -- the drivers keep the
zero-overhead NULL_HOOK path.

Checks (all engine-free: pure reductions on the ticked tensors, no
redistribute/panel_spread entries, so the redistribution counts of a
monitored run are those of an unmonitored one):

  * **NaN/Inf scan** -- every inexact-dtype leaf of every tick; the first
    non-finite phase is what a corrupted collective payload (see
    :mod:`.faults`) surfaces as.
  * **Growth estimate** -- running ``max |ticked panel/update| / max |A|``,
    the practical stand-in for the factorization growth factor.
  * **Diagonal checks** -- driver-aware: LU's packed ``panel`` ticks carry
    the pivots on the diagonal (near-zero pivot == (near-)singular);
    Cholesky's ``diag`` ticks carry L11 (non-positive / near-zero
    diagonal == not positive definite); QR's packed panel carries R's
    diagonal.

Evaluation is DEFERRED: a tick records device scalars (one max-magnitude
reduction per leaf, whose finiteness is the leaf's -- a NaN or an
infinity anywhere makes ``max |x|`` non-finite -- plus the diagonal
minima), and nothing syncs with the host until :meth:`HealthMonitor.report`,
which brings every tick's scalars over in ONE transfer, builds the
``health_report/v1`` document and bumps ``health_checks`` /
``health_flags`` on the current obs metrics registry, and attaches a
``health:<kind>`` instant per flag to the active tracer, when there is
one.

``health_report/v1``::

    {"schema": "health_report/v1", "driver": "lu", "ok": false,
     "checks": 12,                       # ticks inspected
     "flags": [{"kind": "nonfinite", "phase": "update", "step": 3,
                "value": null}, ...],    # kinds: nonfinite | growth |
                                         #   small_pivot | nonpositive_diag
                                         #   | abft
     "growth_estimate": 1.8,             # max |intermediate| / max |A|
     "scale": 3.2,                       # max |A| (the growth anchor)
     "min_diag": 0.41,                   # worst diagonal seen (driver units)
     "failing_phase": "update" | null}   # first flagged phase
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

HEALTH_SCHEMA = "health_report/v1"

#: growth-estimate flag threshold: |intermediate| exceeding ``max|A|`` by
#: this factor marks the factorization as suspect (partial pivoting keeps
#: the ratio near O(n); a corrupted payload or a lost CALU tournament
#: lands orders of magnitude beyond it)
GROWTH_LIMIT = 1e8

#: phases whose FIRST inexact leaf carries a meaningful diagonal, per
#: driver: LU packs the pivots on the panel diagonal, Cholesky factors
#: L11 in the diag phase, and QR's packed panel carries R's diagonal
#: (the larfg betas -- near-zero == rank-deficient, the ``small_pivot``
#: flag).  Other drivers get scan + growth only.
DIAG_PHASES = {"lu": ("panel",), "cholesky": ("diag",), "qr": ("panel",)}


def _float_leaves(arrays):
    """Inexact-dtype tensor leaves of a tick payload (a DistMatrix
    contributes its storage tensor, tuples and lists are walked; int
    permutation vectors and non-tensors are skipped)."""
    out = []
    stack = list(arrays)[::-1]
    while stack:
        leaf = stack.pop()
        if isinstance(leaf, (tuple, list)):
            stack.extend(list(leaf)[::-1])
            continue
        leaf = getattr(leaf, "local", leaf)
        if isinstance(leaf, torch.Tensor) and (leaf.is_floating_point()
                                               or leaf.is_complex()):
            out.append(leaf)
    return out


def _maxabs(x):
    """``max |x|`` as a device scalar, NaN when ``x`` holds a NaN (so its
    finiteness is the leaf's); real tensors take one min/max pass and
    never materialize ``|x|``."""
    if x.is_complex():
        return x.abs().amax()
    lo, hi = torch.aminmax(x)
    return torch.maximum(hi, -lo)


def _eps_of(dtype) -> float:
    real = {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)
    return float(torch.finfo(real).eps)


@dataclasses.dataclass
class _Check:
    """One deferred per-tick observation (device scalars until report()).
    ``maxabs`` is ``max |leaf|`` over the tick's inexact leaves: the tick
    is finite exactly when it is."""
    phase: str
    step: int
    maxabs: object          # device scalar
    diag_min: object | None  # device scalar: min pivot/diag magnitude
    diag_signed: object | None  # device scalar: min REAL diag (cholesky)


class HealthMonitor:
    """Tick-protocol numerical-health guard (see module docstring).

    Reusable as the ``health=`` argument of ``lu``/``cholesky``/``qr``
    (the driver binds the name and input scale at entry) and directly by
    :func:`~elemental_tpu_torch.resilience.certify.certified_solve`, which
    runs one monitor per escalation-ladder attempt.
    """

    def __init__(self, growth_limit: float = GROWTH_LIMIT,
                 diag_rtol: float | None = None):
        self.growth_limit = float(growth_limit)
        self.diag_rtol = diag_rtol        # None: 8*eps(dtype) at report time
        self.driver: str | None = None
        self._scale = None                # deferred device max |A|
        self._eps = None
        self._checks: list[_Check] = []
        self._extra_flags: list[dict] = []
        self._emitted = False
        self._report = None

    # ---- driver binding ---------------------------------------------
    def begin(self, driver: str, scale_from=None) -> "HealthMonitor":
        """Bind the driver name and the growth anchor ``max |A|`` (one
        deferred reduction on the input storage).  Called by the driver's
        ``health=`` plumbing; rebinding RESETS the monitor -- one monitor
        covers one driver invocation (read ``report()`` between runs)."""
        self.driver = str(driver)
        self._checks = []
        self._extra_flags = []
        self._report = None
        self._emitted = False
        if scale_from is not None:
            arr = getattr(scale_from, "local", scale_from)
            if isinstance(arr, torch.Tensor) and arr.numel():
                self._scale = _maxabs(arr)
                self._eps = _eps_of(arr.dtype) \
                    if arr.is_floating_point() or arr.is_complex() else None
        return self

    # ---- tick protocol ------------------------------------------------
    def start(self):
        pass

    def tick(self, phase, step, *arrays):
        leaves = _float_leaves(arrays)
        mx = None
        for leaf in leaves:
            if leaf.numel() == 0:
                continue
            a = _maxabs(leaf)
            mx = a if mx is None else torch.maximum(mx, a)
        if mx is None:
            return                        # nothing to check
        dmin = dsigned = None
        if str(phase) in DIAG_PHASES.get(self.driver or "", ()):
            d = torch.diagonal(leaves[0])
            if d.numel():
                dmin = d.abs().amin()
                dsigned = (d.real if d.is_complex() else d).amin()
        self._checks.append(_Check(str(phase), int(step), mx, dmin,
                                   dsigned))

    def flag(self, kind: str, phase: str, step: int, value=None) -> None:
        """Append an externally-detected flag (the ABFT guard pushes
        UNRECOVERED checksum violations here, kind ``"abft"``, so
        they surface through the same ``health_report/v1`` document and
        ``failing_phase`` plumbing as the monitor's own checks).  Must be
        called before :meth:`report` caches."""
        self._extra_flags.append({"kind": str(kind), "phase": str(phase),
                                  "step": int(step), "value": value})

    # ---- report ------------------------------------------------------
    @property
    def checks(self) -> int:
        return len(self._checks)

    def report(self, emit: bool = True) -> dict:
        """Evaluate the deferred checks into a ``health_report/v1`` doc.

        The first call (with ``emit=True``) also bumps the obs metrics
        registry (and would attach ``health:<kind>`` instants to an active
        tracer); later calls return the cached document."""
        if self._report is not None:
            return self._report
        flags = list(self._extra_flags)
        scale, host = self._host_values()
        gmax = None
        min_diag = None
        for ck, (mx, dv, ds) in zip(self._checks, host):
            if not math.isfinite(mx):
                flags.append({"kind": "nonfinite", "phase": ck.phase,
                              "step": ck.step, "value": None})
                continue                  # maxabs of a NaN tick is noise
            gmax = mx if gmax is None else max(gmax, mx)
            if dv is not None:
                min_diag = dv if min_diag is None else min(min_diag, dv)
                tiny = self._diag_threshold(scale)
                if self.driver == "cholesky" and ds <= 0.0:
                    flags.append({"kind": "nonpositive_diag",
                                  "phase": ck.phase, "step": ck.step,
                                  "value": ds})
                elif dv <= tiny:
                    flags.append({"kind": "small_pivot", "phase": ck.phase,
                                  "step": ck.step, "value": dv})
        growth = None
        if gmax is not None and scale:
            growth = gmax / scale
            if growth > self.growth_limit:
                worst = max(zip(self._checks, host),
                            key=lambda pair: pair[1][0])[0]
                flags.append({"kind": "growth", "phase": worst.phase,
                              "step": worst.step, "value": growth})
        doc = {"schema": HEALTH_SCHEMA, "driver": self.driver,
               "ok": not flags, "checks": len(self._checks), "flags": flags,
               "growth_estimate": growth, "scale": scale,
               "min_diag": min_diag,
               "failing_phase": flags[0]["phase"] if flags else None}
        self._report = doc
        if emit and not self._emitted:
            self._emitted = True
            self._emit(doc)
        return doc

    def _host_values(self):
        """``max |A|`` and each check's ``(maxabs, diag_min, diag_signed)``
        as host floats, brought over in one transfer."""
        vals, where = [], []
        if self._scale is not None:
            vals.append(self._scale)
        for ck in self._checks:
            where.append(len(vals))
            vals.append(ck.maxabs)
            if ck.diag_min is not None:
                vals += [ck.diag_min, ck.diag_signed]
        if not vals:
            return None, []
        flat = torch.stack([v.reshape(()).to(torch.float64)
                            for v in vals]).cpu().tolist()
        scale = flat[0] if self._scale is not None else None
        host = []
        for ck, i in zip(self._checks, where):
            if ck.diag_min is not None:
                host.append((flat[i], flat[i + 1], flat[i + 2]))
            else:
                host.append((flat[i], None, None))
        return scale, host

    def _diag_threshold(self, scale) -> float:
        if self.diag_rtol is not None:
            rtol = self.diag_rtol
        else:
            rtol = 8.0 * (self._eps if self._eps is not None else 1e-7)
        return rtol * (scale if scale else 1.0)

    def _emit(self, doc: dict) -> None:
        from ..obs import metrics as _metrics
        from ..obs.tracer import active_tracer
        drv = doc["driver"] or "?"
        _metrics.inc("health_checks", doc["checks"], driver=drv)
        tr = active_tracer()
        for fl in doc["flags"]:
            _metrics.inc("health_flags", driver=drv, kind=fl["kind"],
                         phase=fl["phase"])
            if tr is not None:
                tr.instant(f"health:{fl['kind']}", driver=drv,
                           phase=fl["phase"], step=fl["step"],
                           value=fl["value"])
        _LAST[drv] = doc
        _LAST["_latest"] = doc


#: the most recent emitted report per driver (+ "_latest"); the
#: ``health=True`` convenience form lands here so callers who did not
#: keep the monitor can still read the outcome.
_LAST: dict = {}


def last_health_report(driver: str | None = None) -> dict | None:
    """The most recently emitted ``health_report/v1`` (per driver, or the
    latest overall with ``driver=None``)."""
    return _LAST.get(driver if driver is not None else "_latest")


def attach_health(driver: str, health, hook, scale_from=None):
    """Resolve a driver's ``health=`` argument into (hook', monitor).

    ``health`` may be a :class:`HealthMonitor` (caller-owned: read
    ``monitor.report()`` afterwards) or any truthy value (driver-internal
    monitor; the emitted report is retrievable via
    :func:`last_health_report`).  The returned hook fans ticks out to both
    the existing hook (a timer or NULL_HOOK) and the
    monitor; with a falsy ``health`` the hook passes through untouched."""
    if not health:
        return hook, None
    mon = health if isinstance(health, HealthMonitor) else HealthMonitor()
    mon.begin(driver, scale_from=scale_from)
    from ..obs.tracer import NULL_HOOK, _Fanout
    if hook is NULL_HOOK or hook is None:
        return mon, mon
    return _Fanout((hook, mon)), mon


def factor_diag_info(op: str, factor) -> dict:
    """Structured singularity signal from a packed factor's diagonal.

    ``op``: ``'lu'`` (packed L\\U: the diagonal holds U's pivots;
    non-finite or numerically-zero -- ``|u_kk| <= k * eps * max|u|``, the
    floating-point image of an exactly-singular input -- == singular) or
    ``'hpd'`` (Cholesky L/U factor: non-finite or non-positive /
    numerically-zero real diagonal == not positive definite).  Returns::

        {"singular": bool, "diag_index": first offending index | None,
         "finite": bool}

    Engine-free (``get_diagonal`` is a pure storage gather), so the
    signal is trustworthy even under fault injection."""
    from ..blas.level1 import get_diagonal
    d = get_diagonal(factor).local.cpu().numpy().ravel()
    finite = bool(np.isfinite(d).all())
    mag = np.abs(d[np.isfinite(d)])
    dmax = float(mag.max()) if mag.size else 0.0
    eps = float(np.finfo(d.dtype).eps) if np.issubdtype(d.dtype, np.inexact) \
        else 0.0
    tiny = max(d.size, 1) * eps * dmax
    if op == "lu":
        bad = ~np.isfinite(d) | (np.abs(d) <= tiny)
    else:
        bad = ~np.isfinite(d) | (np.real(d) <= tiny)
    idx = int(np.argmax(bad)) if bad.any() else None
    return {"singular": bool(bad.any()), "diag_index": idx, "finite": finite}
