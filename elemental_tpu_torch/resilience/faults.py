"""Deterministic fault injection for the redistribution engine.

PyTorch port of ``elemental_tpu/resilience/faults.py``.  A seeded
:class:`FaultPlan` installs into ``redist.engine`` (the one choke point
every driver's data motion routes through) and corrupts CHOSEN public
``redistribute`` / ``panel_spread`` payloads, or the drivers' local panel
outputs (the ``'compute'`` target, routed through ``engine.apply_fault``),
on CHOSEN calls, so tests can prove each corruption class is either
repaired by the certified-solve escalation ladder or surfaced as a health
report -- never silently propagated into results.

Determinism is the contract: every corruption site derives its own
``numpy`` Generator from ``(seed, target, call index, output index,
kind)``, so an identical plan replayed over an identical run produces
BIT-IDENTICAL corrupted payloads; the :attr:`FaultPlan.log` records
(flat indices, before, after) per event for exactly that comparison.
The stacked storage is the JAX package's bit for bit, so the same plan
over the same run logs the same events in both packages.

Corruption classes (``FaultSpec.kind``):

  * ``'bitflip'``  -- XOR one high (exponent-region) bit of each chosen
    element: the single-event-upset model;
  * ``'scale'``    -- multiply chosen elements by ``FaultSpec.factor``
    (default 1e12): the growth-blowup model, finite but catastrophic;
  * ``'nan'``      -- splat NaN: the poisoned-collective model.

Targets (``FaultSpec.target``): ``'redistribute'`` and ``'panel_spread'``
-- the engine's two public data-motion entries -- plus ``'compute'``,
the lu/cholesky/qr panel outputs.  Call indices count Python-level
entries per target (the counting of ``engine.REDIST_COUNTS``), starting
at 0 when the plan is installed; ``every=True`` corrupts every call from
``call`` onward (the persistent-corruption mode certified solves must
SURFACE, vs the one-shot mode they must REPAIR).

Only the chosen elements cross to the host: they are gathered on the
device, corrupted with the numpy generator, and written into a COPY of
the payload (``index_put``), never into the payload itself -- on a 1x1
grid a redistribution can hand back a view of the caller's storage, and
a rolled-back panel must re-execute from clean data.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.distmatrix import _numpy_dtype

FAULT_KINDS = ("bitflip", "scale", "nan")
#: 'compute' comes last: the enumerate-derived seed words below keep the
#: engine targets' corruption streams where the JAX package has them
FAULT_TARGETS = ("redistribute", "panel_spread", "compute")

#: stable per-target / per-kind seed words (never reorder: part of the
#: determinism contract -- a plan's corruption stream is pinned by tests)
_TARGET_WORD = {t: i + 1 for i, t in enumerate(FAULT_TARGETS)}
_KIND_WORD = {k: i + 1 for i, k in enumerate(FAULT_KINDS)}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One corruption rule of a plan.

    ``window=(start, stop)`` scopes the rule to driver panel
    STEPS ``start <= k < stop`` -- drivers that announce their current
    step via ``engine.set_fault_step`` (the ABFT-guarded factorizations)
    gate the rule on it, so chaos can deterministically corrupt a chosen
    panel.  Windowed one-shot rules (``every=False``) fire exactly ONCE:
    on the first matching call inside the window (``call`` then acts as
    a minimum call index, default 0) -- so a recovery retry of the
    corrupted panel re-executes CLEAN.  ``every=True`` windows corrupt
    every in-window call from ``call`` onward.  Outside any
    ``set_fault_step`` scope a windowed rule never fires; the corruption
    stream of non-windowed rules is unchanged (replay bit-identity)."""
    target: str                  # "redistribute" | "panel_spread" | "compute"
    kind: str                    # "bitflip" | "scale" | "nan"
    call: int = 0                # nth public entry of ``target`` (0-based)
    every: bool = False          # corrupt every call index >= ``call``
    nelem: int = 1               # elements corrupted per payload array
    factor: float = 1e12         # 'scale' multiplier
    window: tuple | None = None  # (start, stop) panel-step scope

    def __post_init__(self):
        if self.target not in FAULT_TARGETS:
            raise ValueError(f"unknown fault target {self.target!r}; "
                             f"expected one of {FAULT_TARGETS}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.call < 0 or self.nelem < 1:
            raise ValueError("FaultSpec needs call >= 0 and nelem >= 1")
        if self.window is not None:
            w = tuple(self.window)
            if len(w) != 2 or int(w[0]) < 0 or int(w[1]) <= int(w[0]):
                raise ValueError("FaultSpec window needs (start, stop) "
                                 "with 0 <= start < stop")
            object.__setattr__(self, "window", (int(w[0]), int(w[1])))

    def matches(self, target: str, call: int,
                step: int | None = None) -> bool:
        if self.target != target:
            return False
        if self.window is not None:
            if step is None or not (self.window[0] <= step
                                    < self.window[1]):
                return False
            return call >= self.call  # one-shot gating lives in the plan
        return call >= self.call if self.every else call == self.call


@dataclasses.dataclass
class FaultEvent:
    """One applied corruption (host copies -- the determinism evidence)."""
    target: str
    call: int
    output: int                  # index within the entry's output tuple
    kind: str
    shape: tuple
    dtype: str
    indices: np.ndarray          # flat element indices corrupted
    before: np.ndarray
    after: np.ndarray
    step: int | None = None      # announced panel step, if any


class FaultPlan:
    """A seeded, replayable corruption schedule (see module docstring).

    Install with ``redist.engine.fault_injection(plan)`` (re-exported as
    ``elemental_tpu_torch.resilience.fault_injection``); :meth:`reset` rewinds
    the call counters and the log so the SAME plan object can replay a
    second identical run for bit-identity comparison."""

    def __init__(self, seed: int, faults):
        self.seed = int(seed)
        self.faults = tuple(faults)
        for f in self.faults:
            if not isinstance(f, FaultSpec):
                raise TypeError(f"FaultPlan needs FaultSpec entries, got "
                                f"{type(f).__name__}")
        self.calls: dict = {t: 0 for t in FAULT_TARGETS}
        self.log: list[FaultEvent] = []
        self.step: int | None = None      # current driver panel step
        self._window_fired: set = set()   # one-shot windowed rules spent

    def reset(self) -> "FaultPlan":
        self.calls = {t: 0 for t in FAULT_TARGETS}
        self.log = []
        self.step = None
        self._window_fired = set()
        return self

    def set_step(self, step: int | None) -> None:
        """Announce the driver's current panel step (``None`` = outside
        any step scope).  Drivers call this through
        ``engine.set_fault_step``; it gates ``window=`` rules only."""
        self.step = None if step is None else int(step)

    # ---- the engine-facing entry ------------------------------------
    def apply(self, target: str, outputs: tuple) -> tuple:
        """Count one public ``target`` entry and return the (possibly
        corrupted) output tensors."""
        call = self.calls[target]
        self.calls[target] = call + 1
        matched = [(si, f) for si, f in enumerate(self.faults)
                   if f.matches(target, call, self.step)
                   and not (f.window is not None and not f.every
                            and si in self._window_fired)]
        if not matched:
            return tuple(outputs)
        specs = []
        for si, f in matched:
            if f.window is not None and not f.every:
                self._window_fired.add(si)  # windowed one-shot: now spent
            specs.append(f)
        out = list(outputs)
        for spec in specs:
            for oi, arr in enumerate(out):
                out[oi] = self._corrupt(arr, spec, target, call, oi)
        return tuple(out)

    # ---- corruption kernels -----------------------------------------
    def _corrupt(self, arr, spec: FaultSpec, target: str, call: int,
                 oi: int):
        dt = _numpy_dtype(arr.dtype)
        if dt is None or not np.issubdtype(dt, np.inexact) \
                or arr.numel() == 0:
            return arr
        rng = np.random.default_rng(
            [self.seed, _TARGET_WORD[target], call, oi,
             _KIND_WORD[spec.kind]])
        n = int(arr.numel())
        k = min(int(spec.nelem), n)
        idx = np.sort(rng.choice(n, size=k, replace=False))
        shape = tuple(arr.shape)
        coords = tuple(torch.as_tensor(c, device=arr.device)
                       for c in np.unravel_index(idx, shape))
        before = arr[coords].cpu().numpy().copy()
        after = self._values(before, spec, rng, dt)
        new = arr.index_put(coords, torch.from_numpy(
            np.ascontiguousarray(after)).to(arr.device))
        self.log.append(FaultEvent(
            target=target, call=call, output=oi, kind=spec.kind,
            shape=shape, dtype=dt.name,
            indices=idx, before=before, after=after.copy(),
            step=self.step))
        return new

    @staticmethod
    def _values(before: np.ndarray, spec: FaultSpec, rng, dt) -> np.ndarray:
        if spec.kind == "nan":
            return np.full_like(before, np.nan)
        if spec.kind == "scale":
            return (before * before.dtype.type(spec.factor)).astype(dt)
        # bitflip: XOR one exponent-region bit per element (complex flips
        # the real component's representation)
        vals = before.copy()
        comp = np.iscomplexobj(vals)
        re = np.ascontiguousarray(vals.real) if comp else vals
        fdt = re.dtype
        udt = np.dtype(f"uint{fdt.itemsize * 8}")
        bits = fdt.itemsize * 8
        # mantissa-top .. exponent bits: always a macroscopic change, never
        # the sign bit alone
        b = rng.integers(bits - 12, bits - 1, size=vals.shape)
        mask = np.left_shift(np.ones_like(b, dtype=udt), b.astype(udt))
        flipped = (re.view(udt) ^ mask).view(fdt)
        if comp:
            return (flipped + 1j * vals.imag).astype(dt)
        return flipped.astype(dt)

    # ---- summaries ---------------------------------------------------
    def fired(self) -> int:
        """Number of corruption events applied so far."""
        return len(self.log)

    def summary(self) -> list:
        return [{"target": ev.target, "call": ev.call, "output": ev.output,
                 "kind": ev.kind, "nelem": int(ev.indices.size)}
                for ev in self.log]


def logs_identical(a: FaultPlan, b: FaultPlan) -> bool:
    """Bit-exact comparison of two plans' corruption logs (the
    determinism oracle: same seed + same run => identical)."""
    if len(a.log) != len(b.log):
        return False
    for ea, eb in zip(a.log, b.log):
        if (ea.target, ea.call, ea.output, ea.kind, ea.shape, ea.dtype,
                ea.step) \
                != (eb.target, eb.call, eb.output, eb.kind, eb.shape,
                    eb.dtype, eb.step):
            return False
        if not np.array_equal(ea.indices, eb.indices):
            return False
        if ea.before.tobytes() != eb.before.tobytes() \
                or ea.after.tobytes() != eb.after.tobytes():
            return False
    return True
