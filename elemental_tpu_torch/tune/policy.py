"""The canonical blocksize rule.

PyTorch port of ``elemental_tpu/tune/policy.py:blocksize_policy``; the
knob resolver (``'auto'``) belongs to the tuner, a later slice.
"""
from __future__ import annotations


def blocksize_policy(nb, grain: int, extent: int) -> int:
    """Resolve an ``nb`` request to a legal block size: ``None`` reads the
    global :func:`~elemental_tpu_torch.core.environment.blocksize` stack,
    the result is rounded up to the distribution ``grain`` (views must
    start and end on stride boundaries) and clamped to the grain-rounded
    ``extent``."""
    if isinstance(nb, str):
        raise NotImplementedError(
            f"nb={nb!r}: 'auto' needs the tuner, which is not ported yet "
            "(a later slice); pass an int")
    from ..core.view import round_up
    if nb is None:
        from ..core.environment import blocksize
        nb = blocksize()
    nb = round_up(max(nb, 1), grain)
    return min(nb, round_up(max(extent, 1), grain))
