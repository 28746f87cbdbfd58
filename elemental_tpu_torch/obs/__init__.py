"""Runtime observability: spans, metrics, exporters, serving telemetry.

PyTorch port of ``elemental_tpu/obs`` whole:

  :mod:`.tracer`       span tracer: ``Tracer`` (nested spans via
                       ``span()``, driver tick channels, engine collective
                       observer) + :func:`phase_hook`, the driver
                       integration all six tuned drivers call
  :mod:`.metrics`      counters / gauges / histograms ->
                       ``obs_metrics/v1``
  :mod:`.phase_timer`  ``PhaseTimer`` over the tracer
                       (``phase_timings/v1``)
  :mod:`.export`       Chrome-trace/Perfetto ``trace.json`` rendering
                       (thread-keyed tracks + request flow events)
  :mod:`.lifecycle`    per-request ``RequestTrace`` ->
                       ``serve_timeline/v1``
  :mod:`.slo`          windowed SLO burn rates -> ``serve_slo/v1``
  :mod:`.flight`       fault-triggered flight recorder ->
                       ``flight_record/v1``

CLI: ``python -m elemental_tpu_torch.obs {run,summary,export}``.
"""
from .metrics import (SCHEMA as METRICS_SCHEMA, FAMILIES as HIST_FAMILIES,
                      MetricsRegistry, REGISTRY,
                      current as current_metrics, scoped as metrics_scope,
                      hist_family, inc, observe, set_gauge,
                      set_hist_family)
from .tracer import (TRACE_SCHEMA, CommEvent, InstantEvent, NullHook,
                     NULL_HOOK, PhaseRecord, Span, Tracer, active_tracer,
                     phase_hook, ring_bytes)
from .phase_timer import PHASES, SCHEMA as PHASE_TIMINGS_SCHEMA, PhaseTimer
from .export import (CHROME_SCHEMA, chrome_trace_doc,
                     phase_timings_to_chrome, write_json)
from .lifecycle import (SCHEMA as TIMELINE_SCHEMA, EDGES as LIFECYCLE_EDGES,
                        RequestTrace, check_timeline)
from .slo import (SCHEMA as SLO_SCHEMA, SLOMonitor, SLOTarget)
from .flight import (SCHEMA as FLIGHT_SCHEMA, FlightRecorder)

__all__ = [
    "METRICS_SCHEMA", "HIST_FAMILIES", "MetricsRegistry", "REGISTRY",
    "current_metrics", "metrics_scope", "hist_family", "inc", "observe",
    "set_gauge", "set_hist_family",
    "TRACE_SCHEMA", "CommEvent", "InstantEvent", "NullHook", "NULL_HOOK",
    "PhaseRecord", "Span", "Tracer", "active_tracer", "phase_hook",
    "ring_bytes",
    "PHASES", "PHASE_TIMINGS_SCHEMA", "PhaseTimer",
    "CHROME_SCHEMA", "chrome_trace_doc", "phase_timings_to_chrome",
    "write_json",
    "TIMELINE_SCHEMA", "LIFECYCLE_EDGES", "RequestTrace", "check_timeline",
    "SLO_SCHEMA", "SLOMonitor", "SLOTarget",
    "FLIGHT_SCHEMA", "FlightRecorder",
]
