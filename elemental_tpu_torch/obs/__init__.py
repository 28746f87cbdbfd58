"""Observability: the null tick hook and the metrics registry.

``metrics`` is the JAX package's ``obs/metrics.py`` whole; of the tracer
only the null hook and :func:`active_tracer` (always ``None`` until the
tracer is ported) are here."""
from .metrics import (SCHEMA as METRICS_SCHEMA, FAMILIES as HIST_FAMILIES,
                      MetricsRegistry, REGISTRY,
                      current as current_metrics, scoped as metrics_scope,
                      hist_family, inc, observe, set_gauge,
                      set_hist_family)
from .tracer import NULL_HOOK, NullHook, active_tracer, phase_hook

__all__ = [
    "METRICS_SCHEMA", "HIST_FAMILIES", "MetricsRegistry", "REGISTRY",
    "current_metrics", "metrics_scope", "hist_family", "inc", "observe",
    "set_gauge", "set_hist_family",
    "NullHook", "NULL_HOOK", "active_tracer", "phase_hook",
]
