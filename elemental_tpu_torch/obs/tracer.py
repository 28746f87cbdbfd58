"""The drivers' tick hook: the null hook and the active-tracer slot.

PyTorch port of ``NULL_HOOK`` / ``phase_hook`` / ``active_tracer`` from
``elemental_tpu/obs/tracer.py``.  Drivers call ``tick()`` unconditionally;
with no timer the hook does nothing.  Tracers and phase timers belong to
a later slice (the drivers refuse ``timer=`` until then), so
:func:`active_tracer` returns ``None``: the resilience layer's
``abft:recover`` span and ``health:*`` instants are not emitted yet.
"""
from __future__ import annotations


class NullHook:
    """Zero-overhead stand-in so drivers can call tick() unconditionally."""
    __slots__ = ()

    def start(self):
        pass

    def tick(self, phase, step, *arrays):
        pass


NULL_HOOK = NullHook()


def phase_hook(driver: str, timer=None):
    """This invocation's tick hook: ``timer`` when given, else
    :data:`NULL_HOOK`."""
    return NULL_HOOK if timer is None else timer


def active_tracer():
    """The tracer currently activated via ``with tracer:``, if any.  No
    tracer is ported yet, so this is always ``None``."""
    return None
