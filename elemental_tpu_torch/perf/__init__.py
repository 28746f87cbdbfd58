"""Perf tooling of the port (the twins of the JAX package's ``perf/``
tools that have none in the package): the same-process A/B harness
(:mod:`.ab_harness`), the redistribution microbench (:mod:`.redist_bench`),
the panel-kernel smoke (:mod:`.kernels`) and the ``PhaseTimer`` import
path (:mod:`.phase_timer`).  Each runs on ``cuda:0`` unless ``--device
cpu``."""
