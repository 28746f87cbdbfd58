"""Certified solves: residual certificate + deterministic escalation.

PyTorch port of ``elemental_tpu/resilience/certify.py``.
:func:`certified_solve` wraps the ``lu_solve`` / ``hpd_solve`` drivers
into the retry/backoff shape for NUMERICAL failure: run the fast
configuration first, measure the TRUE residual through a trusted path,
iteratively refine, and on certification failure climb a deterministic
escalation ladder -- each rung's configuration in the tuner's knob
vocabulary (``panel`` / ``update_precision`` / ``precision`` /
``lookahead``; see ``tune.knobs``) -- until a rung certifies or the
ladder is exhausted.

The ladder (order pinned by the tests)::

    quant    wire-quantized fast configuration: the same
             speed-first knobs as 'fast' PLUS ``comm_precision='int8'``
             -- block-scaled int8/bf16 payloads on every bulk collective,
             2-4x fewer bytes on the wire -- with a refinement budget
             (8 iterations) sized so the ~1e-2 quantized-factor error
             refines down to fp64-class tolerances on well-conditioned
             systems.  On 1x1 grids the knob is a no-op (bit-identical
             to 'fast').
    fast     speed-first factorization: CALU tournament panel (lu) /
             default-precision trailing updates, full-precision wire
    refine   SAME factor, larger iterative-refinement budget (cheapest
             escalation: no refactorization)
    abft     refactor under the checksum-guarded classic schedule
             (``abft=True``): a transient fault is repaired at panel
             granularity inside the driver
    fp32     refactor with full-precision trailing updates
    classic  refactor with the classic (partial-pivot / classic-schedule)
             panel -- the maximum-stability baseline

The port has no reduced-precision matmul (``core.environment.PRECISIONS``
is ``(None, 'highest')``), so where the JAX package's 'fast' rungs ask
for ``lax.Precision.DEFAULT`` the port asks for ``None``: on the CPU the
two are the same full-f32 arithmetic, and on the card 'fast' and 'fp32'
do the same arithmetic until reduced-precision matmuls are ported.  The
six rungs keep their names, order and refinement budgets.

Trust boundary: the certificate's residual is computed HOST-SIDE in
float64 from ``to_global`` snapshots (pure storage gathers -- no engine
collectives), so a fault-injected or otherwise corrupted redistribution
layer (see :mod:`.faults`) can corrupt the SOLVE but never the
MEASUREMENT: a garbage solution cannot be certified, and a clean
escalation rung certifies even while lower rungs are being corrupted.
Each factorization attempt runs under its own
:class:`~elemental_tpu_torch.resilience.health.HealthMonitor`, so a failed
certificate carries the health report naming the failing phase.

``solve_certificate/v1`` (the ``info`` return)::

    {"schema": "solve_certificate/v1", "op": "lu", "certified": true,
     "rung": "fast",                  # certifying rung (None on failure)
     "residual": 3.1e-15, "tol": 6.8e-13,
     "refine_iters": 0,              # iterations at the certifying rung
     "ladder": ["fast", "refine", "fp32", "classic"],
     "attempts": [{"rung", "residual", "refine_iters", "singular",
                   "diag_index", "health"}, ...],
     "singular": false,              # every FULL-WIRE attempt was singular
                                     #   (a wire-quantized factorization
                                     #   perturbs exact zeros off the
                                     #   diagonal, so quant rungs cannot
                                     #   attest singularity either way)
     "timed_out": false,             # a ``deadline=`` expired before the
                                     #   ladder finished: the
                                     #   certificate is best-so-far, not
                                     #   the full ladder's verdict
     "failing_phase": null,          # first health-flagged phase /
                                     #   "diag" (singular) / "deadline"
                                     #   (timed out, no other evidence) /
                                     #   "residual"
     "health": {...}}                # last attempt's health_report/v1

The residual certified is ``||B - A X||_F / (||A||_F ||X||_F + ||B||_F)``
(normwise relative backward error); the documented default tolerance is
``64 * n * eps(A.dtype)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .faults import _numpy_dtype
from .health import HealthMonitor

CERT_SCHEMA = "solve_certificate/v1"

#: documented default certification tolerance: ``TOL_FACTOR * n * eps``
TOL_FACTOR = 64.0

#: canonical ladder rung names, in escalation order (pinned by tests).
#: 'abft' sits between the cheap re-refine rung and the full fp32
#: refactorization: a TRANSIENT fault is repaired by re-executing one
#: panel (checksum-guarded classic schedule) before the ladder pays for
#: whole-solve escalation.
LADDER_NAMES = ("quant", "fast", "refine", "abft", "fp32", "classic")


@dataclasses.dataclass(frozen=True)
class Rung:
    """One escalation rung: a driver knob configuration + budgets."""
    name: str
    config: dict                 # driver kwargs (tuner knob vocabulary)
    refine: int                  # iterative-refinement budget
    refactor: bool = True        # fresh factorization at this rung?


def default_ladder(op: str):
    """The documented ladder for ``op`` ('lu' | 'hpd').  Rung configs are
    knob dicts in the tuner's vocabulary (``tune.knobs``): 'quant' is the
    wire-quantized rung ('fast' + ``comm_precision='int8'``,
    ``COMM_PRECISIONS[2]``), 'fast' rides the CALU panel
    (``LU_PANELS[1]``; classic on single-row grids inside the driver),
    'abft' re-factors under the checksum-guarded classic schedule
    (``abft=True``: a transient fault is detected and repaired at PANEL
    granularity inside the driver), 'classic' is ``LU_PANELS[0]`` / the
    classic schedule.  Where the JAX ladder asks for
    ``lax.Precision.DEFAULT`` this one asks for ``None`` and where it
    asks for ``HIGHEST``, ``'highest'`` (see the module docstring)."""
    from ..tune.knobs import COMM_PRECISIONS
    q8 = COMM_PRECISIONS[2]                      # 'int8'
    if op == "lu":
        from ..tune.knobs import LU_PANELS
        classic, calu = LU_PANELS
        fast = {"panel": calu, "update_precision": None}
        return (
            Rung("quant", {**fast, "comm_precision": q8}, refine=8),
            Rung("fast", fast, refine=2),
            Rung("refine", fast, refine=8, refactor=False),
            Rung("abft", {"abft": True, "update_precision": None},
                 refine=4),
            Rung("fp32", {"panel": calu, "update_precision": None},
                 refine=4),
            Rung("classic", {"panel": classic, "update_precision": None},
                 refine=4),
        )
    if op == "hpd":
        fast = {"precision": None}
        return (
            Rung("quant", {**fast, "comm_precision": q8}, refine=8),
            Rung("fast", fast, refine=2),
            Rung("refine", fast, refine=8, refactor=False),
            Rung("abft", {"abft": True, "precision": None}, refine=4),
            Rung("fp32", {"precision": "highest"}, refine=4),
            Rung("classic", {"precision": "highest",
                             "lookahead": False}, refine=4),
        )
    raise ValueError(f"certified_solve op must be 'lu' or 'hpd', got {op!r}")


def default_tol(n: int, dtype) -> float:
    from .health import _eps_of
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    return TOL_FACTOR * max(int(n), 1) * _eps_of(dtype)


# ---------------------------------------------------------------------
# trusted host-side measurement (engine-free: to_global is a storage
# gather, and the residual is float64 numpy on the host)
# ---------------------------------------------------------------------

def _host(A) -> np.ndarray:
    from ..core.distmatrix import to_global
    arr = to_global(A).cpu().numpy()
    return arr.astype(np.complex128 if np.iscomplexobj(arr) else np.float64)


def _residual(An, Bn, Xn, normA, normB) -> float:
    # corrupted solves legitimately overflow here; inf is the verdict
    with np.errstate(over="ignore", invalid="ignore"):
        r = Bn - An @ Xn
        normX = np.linalg.norm(Xn)
        den = normA * normX + normB
        if not np.isfinite(den) or den == 0.0:
            return float("inf")
        res = np.linalg.norm(r) / den
    return float(res) if np.isfinite(res) else float("inf")


# ---------------------------------------------------------------------
# per-op factor / solve-after adapters
# ---------------------------------------------------------------------

def _factor(op: str, A, nb, config: dict, monitor):
    if op == "lu":
        from ..lapack.lu import lu
        return lu(A, nb=nb, health=monitor, **config)
    from ..lapack.cholesky import cholesky
    return cholesky(A, "L", nb=nb, health=monitor, **config)


def _solve_after(op: str, factor, B, nb):
    if op == "lu":
        from ..lapack.lu import lu_solve_after
        LU_, perm = factor
        return lu_solve_after(LU_, perm, B, nb=nb)
    from ..lapack.cholesky import cholesky_solve_after
    return cholesky_solve_after(factor, B, "L", nb=nb)


def _factor_matrix(op: str, factor):
    return factor[0] if op == "lu" else factor


# ---------------------------------------------------------------------
# the certified solve
# ---------------------------------------------------------------------

def certified_solve(op: str, A, B, *, tol: float | None = None,
                    nb: int | None = None, ladder=None, health: bool = True,
                    deadline=None):
    """Solve ``A X = B`` with a residual certificate and escalation.

    ``op``: ``'lu'`` (general square A) or ``'hpd'`` (Hermitian positive
    definite A; ``'cholesky'`` is accepted as an alias).  Returns
    ``(X, info)`` with ``info`` a ``solve_certificate/v1`` document (see
    module docstring); ``X`` is the best solution produced (``None`` when
    no attempt produced one: every attempted factorization was singular,
    or the deadline expired before the first rung).  ``tol`` defaults
    to the documented ``64 * n * eps(A.dtype)``; ``ladder`` overrides the
    rung sequence (a tuple of :class:`Rung`); ``health=False`` skips the
    per-attempt health monitors (the certificate alone still guards the
    result).  EAGER-mode: the escalation control flow is host-side.

    ``deadline`` bounds wall-clock: any object with a
    ``remaining() -> seconds`` method (the serve layer's ``Deadline`` in
    the JAX package; the port's serve layer is not ported yet).  Every rung attempt -- and
    every refinement iteration -- checks the remaining budget BEFORE
    launching; an exhausted budget stops the ladder and returns the
    best-so-far solution with ``timed_out=True`` in the certificate
    instead of silently running the remaining rungs, so the worst-case
    overrun is one rung, never the whole ladder.
    """
    if op == "cholesky":
        op = "hpd"
    rungs = tuple(ladder) if ladder is not None else default_ladder(op)
    n = int(A.gshape[0])
    if tol is None:
        tol = default_tol(n, A.dtype)
    tol = float(tol)
    An = _host(A)
    Bn = _host(B)
    normA = np.linalg.norm(An)
    normB = np.linalg.norm(Bn)
    dtype = _numpy_dtype(B.dtype)

    from .health import factor_diag_info
    attempts: list = []
    factor = None
    diag = None
    monitor = None
    X = None
    timed_out = False
    best = None                           # (residual, X, refine_iters)
    for rung in rungs:
        if deadline is not None and deadline.remaining() <= 0.0:
            timed_out = True              # check BEFORE launch: the only
            break                         # overrun is the rung in flight
        att = {"rung": rung.name, "residual": None, "refine_iters": 0,
               "singular": False, "diag_index": None, "health": None}
        if rung.refactor or factor is None:
            monitor = HealthMonitor() if health else None
            factor = _factor(op, A, nb, rung.config, monitor)
            diag = factor_diag_info(op, _factor_matrix(op, factor))
        if monitor is not None:
            att["health"] = monitor.report()
        att["singular"] = diag["singular"]
        att["diag_index"] = diag["diag_index"]
        if diag["singular"]:
            attempts.append(att)
            continue                      # solve-after would be garbage
        X = _solve_after(op, factor, B, nb)
        res = _residual(An, Bn, _host(X), normA, normB)
        it = 0
        while res > tol and it < rung.refine and np.isfinite(res):
            if deadline is not None and deadline.remaining() <= 0.0:
                timed_out = True
                break
            with np.errstate(over="ignore", invalid="ignore"):
                Rn = Bn - An @ _host(X)
            if not np.isfinite(Rn).all():
                break
            from ..core.distmatrix import from_global
            from ..core.dist import MC, MR
            Rd = from_global(Rn.astype(dtype), MC, MR, grid=B.grid)
            D = _solve_after(op, factor, Rd, nb)
            X = X.with_local(X.local + D.local)
            it += 1
            new = _residual(An, Bn, _host(X), normA, normB)
            if not (new < 0.9 * res):
                res = min(res, new)
                break                     # refinement stalled: escalate
            res = new
        att["residual"] = res if np.isfinite(res) else None
        att["refine_iters"] = it
        attempts.append(att)
        if np.isfinite(res) and (best is None or res < best[0]):
            best = (res, X, it)
        if np.isfinite(res) and res <= tol:
            return X, _certificate(op, True, rung.name, res, tol, it,
                                   rungs, attempts)
        if timed_out:
            break
    # ladder exhausted or deadline expired: best-so-far, never certified
    if best is not None:
        res_out, X, it_out = best
    else:
        last = attempts[-1] if attempts else None
        res_out = last["residual"] if last and last["residual"] is not None \
            else float("nan")
        it_out = last["refine_iters"] if last else 0
    cert = _certificate(op, False, None, res_out, tol, it_out,
                        rungs, attempts, timed_out=timed_out)
    if cert["singular"]:
        # the only solves produced (if any) came from wire-quantized
        # factors of an attested-singular system: suppress the garbage
        X = None
    return X, cert


def _failing_phase(attempts, timed_out=False) -> str | None:
    for att in attempts:
        rep = att.get("health")
        if rep and rep.get("flags"):
            return rep["flags"][0]["phase"]
    for att in attempts:
        if att.get("singular"):
            return "diag"
    if timed_out:
        return "deadline"                 # budget, not numerics, stopped us
    return "residual"


def _certificate(op, certified, rung, residual, tol, iters, rungs,
                 attempts, timed_out=False) -> dict:
    last_health = None
    for att in reversed(attempts):
        if att.get("health") is not None:
            last_health = att["health"]
            break
    # singularity is attested by the rungs that factored at FULL wire
    # precision: a comm_precision rung's quantization perturbs an exactly
    # zero pivot into a small nonzero one, so its diag verdict is
    # inconclusive in both directions
    attested = [a for a, r in zip(attempts, rungs)
                if not r.config.get("comm_precision")]
    return {"schema": CERT_SCHEMA, "op": op, "certified": bool(certified),
            "rung": rung,
            "residual": None if residual is None or not np.isfinite(residual)
            else float(residual),
            "tol": float(tol), "refine_iters": int(iters),
            "ladder": [r.name for r in rungs],
            "attempts": attempts,
            "singular": bool(attested) and all(a["singular"]
                                               for a in attested),
            "timed_out": bool(timed_out),
            "failing_phase": None if certified
            else _failing_phase(attempts, timed_out),
            "health": last_health}
