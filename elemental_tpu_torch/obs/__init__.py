"""Observability: only the null tick hook is ported so far."""
from .tracer import NULL_HOOK, phase_hook
