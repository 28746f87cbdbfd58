"""Environment: the blocksize stack, the precision policy, timers, CLI
argument parsing and progress logs.

PyTorch port of ``elemental_tpu/core/environment.py`` (Elemental
``src/core/environment.cpp`` -- ``El::Blocksize`` / ``SetBlocksize`` /
``PushBlocksizeStack`` / ``PopBlocksizeStack``, default 128; ``El::Timer``;
the ``El::Input`` / ``ProcessInput`` / ``PrintInputReport`` flag parser as
:class:`Args`; :class:`ProgressLog`).  The stack is plain Python state consulted when an algorithm's ``nb``
argument is None; a with-statement context manager replaces the
reference's push/pop pairs.

The precision policy is the port's counterpart of the JAX package's
``lapack.lu._hi`` (``Precision.HIGHEST`` for every factor-forming matmul):
``precision=None`` and ``'highest'`` mean full float32 / float64
arithmetic.  PyTorch gives that on the card only while
``torch.backends.cuda.matmul.allow_tf32`` is False; the library sets no
global flag itself, so the drivers CHECK it and refuse to run in TF32.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import torch

_DEFAULT_BLOCKSIZE = 128
_blocksize_stack: list[int] = [_DEFAULT_BLOCKSIZE]


def blocksize() -> int:
    """Current algorithmic blocksize (``El::Blocksize``)."""
    return _blocksize_stack[-1]


def set_blocksize(nb: int) -> None:
    """Replace the top of the blocksize stack (``El::SetBlocksize``)."""
    if nb < 1:
        raise ValueError(f"blocksize must be >= 1, got {nb}")
    _blocksize_stack[-1] = int(nb)


def push_blocksize(nb: int) -> None:
    """``El::PushBlocksizeStack``."""
    if nb < 1:
        raise ValueError(f"blocksize must be >= 1, got {nb}")
    _blocksize_stack.append(int(nb))


def pop_blocksize() -> int:
    """``El::PopBlocksizeStack``; the default base entry is never popped."""
    if len(_blocksize_stack) == 1:
        raise RuntimeError("blocksize stack underflow")
    return _blocksize_stack.pop()


class blocksize_scope:
    """``with blocksize_scope(256): ...`` == push/pop pair."""

    def __init__(self, nb: int):
        self.nb = nb

    def __enter__(self):
        push_blocksize(self.nb)
        return self.nb

    def __exit__(self, *exc):
        pop_blocksize()
        return False


#: the ``precision=`` values the port implements
PRECISIONS = (None, "highest")


def check_precision(precision, *tensors) -> None:
    """Validate a driver's ``precision`` and the matmul mode it will run
    in: only full-precision arithmetic is ported, and on a CUDA tensor
    that needs ``torch.backends.cuda.matmul.allow_tf32 is False``.

    Every driver hands its operands' ``local`` here on entry: a device
    grid's :class:`~.ranks.Tiles` refuses the drivers that do not run on
    one (those that do pass their ranks' tensors, :func:`~.ranks.tensors`).
    """
    from .ranks import Tiles, caller_name, refuse
    if any(isinstance(t, Tiles) for t in tensors):
        refuse(caller_name())
    if precision not in PRECISIONS:
        raise NotImplementedError(
            f"precision={precision!r}: only {PRECISIONS} (full float32/"
            "float64 arithmetic) are ported; reduced-precision matmuls "
            "belong to a later slice")
    if any(t.is_cuda for t in tensors) \
            and torch.backends.cuda.matmul.allow_tf32 is not False:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 must be False: the "
            "factorizations need full float32 matmuls (set the flag "
            "before calling; the library sets no global flags)")


# ---------------------------------------------------------------------------
# Timer (El::Timer; the barrier-then-time idiom)
# ---------------------------------------------------------------------------

class Timer:
    """Accumulating wall-clock timer.

    ``start()``/``stop()`` accumulate into ``total()``; ``partial()`` reads
    the running split without stopping.  Passing tensors (or a tuple /
    list / DistMatrix of them) to ``stop(x)`` first waits for their device
    to finish (the reference's ``mpi::Barrier(); timer.Stop()`` pattern):
    on a CUDA tensor one ``torch.cuda.synchronize``, on the CPU nothing.
    """

    def __init__(self, name: str = ""):
        self.name = name
        self._total = 0.0
        self._t0 = None

    def start(self) -> None:
        if self._t0 is not None:
            raise RuntimeError(f"Timer {self.name!r} already running")
        self._t0 = time.perf_counter()

    def stop(self, fence=None) -> float:
        if fence is not None:
            from ..obs.tracer import block_until_ready
            block_until_ready(fence)
        if self._t0 is None:
            raise RuntimeError(f"Timer {self.name!r} not running")
        split = time.perf_counter() - self._t0
        self._total += split
        self._t0 = None
        return split

    def partial(self) -> float:
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0

    def total(self) -> float:
        return self._total + self.partial()

    def reset(self) -> None:
        self._total, self._t0 = 0.0, None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            self.stop()
        return False

    def __repr__(self):
        state = "running" if self._t0 is not None else "stopped"
        return f"Timer({self.name!r}, total={self.total():.6f}s, {state})"


# ---------------------------------------------------------------------------
# CLI input (El::Args / El::Input / ProcessInput / PrintInputReport)
# ---------------------------------------------------------------------------

@dataclass
class _Flag:
    name: str
    description: str
    default: object
    type: type
    required: bool
    value: object = None
    found: bool = False


class Args:
    """Typed flag parser mirroring ``El::Input`` semantics.

    >>> args = Args(["--m", "500", "--upper"])
    >>> m = args.input("--m", "matrix height", 100)
    >>> upper = args.input("--upper", "use upper triangle", False)
    >>> args.process()           # validates; raises on unknown/missing
    >>> m, upper
    (500, True)

    Booleans are presence flags when the next token is another flag (or
    absent), else parse the token (``--upper 1``/``true``/``false``).
    """

    def __init__(self, argv: list[str] | None = None):
        self.argv = list(sys.argv[1:] if argv is None else argv)
        self._flags: dict[str, _Flag] = {}
        self._processed = False

    def input(self, name: str, description: str, default=None, *,
              required: bool = False):
        """Register a flag and return its parsed value (``El::Input<T>``)."""
        if not name.startswith("--"):
            raise ValueError(f"flag names start with '--': {name!r}")
        ftype = type(default) if default is not None else str
        flag = _Flag(name, description, default, ftype, required)
        self._flags[name] = flag
        flag.value, flag.found = self._parse(flag)
        return flag.value

    def _parse(self, flag: _Flag):
        for i, tok in enumerate(self.argv):
            if tok != flag.name:
                continue
            nxt = self.argv[i + 1] if i + 1 < len(self.argv) else None
            if flag.type is bool:
                if nxt is None or nxt.startswith("--"):
                    return True, True
                return nxt.lower() in ("1", "true", "yes", "on"), True
            if nxt is None:
                raise ValueError(f"flag {flag.name} expects a value")
            if flag.type is int:
                return int(nxt), True
            if flag.type is float:
                return float(nxt), True
            if flag.type is complex:
                return complex(nxt), True
            return nxt, True
        return flag.default, False

    def process(self, report: bool = False) -> None:
        """Validate (``El::ProcessInput``): every required flag present, no
        unknown flags in argv."""
        self._processed = True
        missing = [f.name for f in self._flags.values()
                   if f.required and not f.found]
        if missing:
            self.print_report()
            raise ValueError(f"missing required flags: {missing}")
        i = 0
        while i < len(self.argv):
            tok = self.argv[i]
            if tok.startswith("--"):
                if tok == "--help":
                    self.print_report()
                    raise SystemExit(0)
                flag = self._flags.get(tok)
                if flag is None:
                    raise ValueError(f"unknown flag {tok}")
                nxt = self.argv[i + 1] if i + 1 < len(self.argv) else None
                # skip exactly the tokens _parse consumed: non-bool flags
                # always consume the next token; bool flags consume it only
                # when it is a value, not another flag
                if flag.type is not bool:
                    if nxt is not None:
                        i += 1
                elif nxt is not None and not nxt.startswith("--"):
                    i += 1
            i += 1
        if report:
            self.print_report()

    def print_report(self, stream=None) -> None:
        """``El::PrintInputReport``."""
        stream = stream or sys.stdout
        stream.write("Input flags:\n")
        for f in self._flags.values():
            mark = "*" if f.found else " "
            stream.write(f" {mark} {f.name:<16} {f.value!r:<12}"
                         f" ({f.type.__name__}) -- {f.description}\n")


# ---------------------------------------------------------------------------
# Structured progress logging
# ---------------------------------------------------------------------------

@dataclass
class ProgressLog:
    """Per-iteration metric sink used by the IPMs / iterative drivers.

    ``log(it, **metrics)`` records a row and, when ``print_every`` > 0,
    prints a compact line -- the analog of the reference's ``ctrl.progress``
    flag inside ``MehrotraCtrl``/``PseudospecCtrl``.
    """

    name: str = ""
    print_every: int = 0
    rows: list[dict] = field(default_factory=list)

    def log(self, it: int, **metrics) -> None:
        row = {"it": it, **{k: float(v) for k, v in metrics.items()}}
        self.rows.append(row)
        if self.print_every and it % self.print_every == 0:
            body = " ".join(f"{k}={v:.3e}" for k, v in row.items() if k != "it")
            print(f"[{self.name or 'iter'} {it:4d}] {body}")

    def history(self, key: str) -> list[float]:
        return [r[key] for r in self.rows if key in r]
