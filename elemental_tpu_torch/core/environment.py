"""Environment: the algorithmic blocksize stack and the precision policy.

PyTorch port of the blocksize stack of ``elemental_tpu/core/environment.py``
(Elemental ``src/core/environment.cpp`` -- ``El::Blocksize`` /
``SetBlocksize`` / ``PushBlocksizeStack`` / ``PopBlocksizeStack``, default
128).  The stack is plain Python state consulted when an algorithm's ``nb``
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
    that needs ``torch.backends.cuda.matmul.allow_tf32 is False``."""
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
