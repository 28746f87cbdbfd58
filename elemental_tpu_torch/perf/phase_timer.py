"""The ``PhaseTimer`` import path of the JAX package's
``perf/phase_timer.py``: it re-exports ``PHASES``, ``SCHEMA`` and
``PhaseTimer`` from :mod:`elemental_tpu_torch.obs.phase_timer`, where the
per-phase wall-clock attribution (``phase_timings/v1``) lives::

    from elemental_tpu_torch.perf.phase_timer import PhaseTimer, SCHEMA, PHASES

``python -m elemental_tpu_torch.obs`` is the full tracing CLI.
"""
from ..obs.phase_timer import PHASES, SCHEMA, PhaseTimer  # noqa: F401
