"""Solver service: deadline-bounded, batched, fault-isolated serving.

PyTorch port of ``elemental_tpu/serve`` whole: the front-end that turns
the single-solve machinery into a system that survives production
traffic -- the ROADMAP's "millions of users" workload of many
small-to-medium solves (arXiv 2112.09017):

  :mod:`.admission`  shape-bucketing into the tuner's pow2 buckets,
                     per-request :class:`Deadline` objects threaded
                     through dispatch, and load shedding that
                     rejects-fast with ``serve_reject/v1``
  :mod:`.executor`   padded batched Cholesky/LU/QR solves with a
                     persistent cache of captured CUDA graphs (no
                     request pays a capture)
  :mod:`.policy`     deadline-aware retry with seeded backoff+jitter,
                     the per-bucket circuit breaker (trip / half-open
                     probe / close), and the load-aware degradation
                     ladder (quant-first under pressure)
  :mod:`.service`    :class:`SolverService` -- submit/drain, trusted
                     per-request certification, bisect fault isolation,
                     escalation through ``certified_solve(deadline=)``
                     (the hand-written kernels' path)
  :mod:`.async_front` :class:`AsyncSolverService` -- the pipelined
                     front: one worker thread stages batch k+1 while
                     batch k runs on the executor's stream, completions
                     stream as :class:`ServeFuture` resolutions
  :mod:`.chaos`      the acceptance-matrix harness over the
                     ``FaultPlan`` machinery, with a fleet column
                     (saturation + grid loss)
  :mod:`.scheduler`  :class:`FairScheduler` -- per-tenant deficit-round-
                     robin queues and :class:`TenantQuota` outstanding
                     caps
  :mod:`.fleet`      :class:`SolverFleet` -- the virtual grid's ranks
                     partitioned into independent solver grids (own
                     executor cache / stream / breakers / tuner
                     namespace / EWMA each), depth-k pipelined workers,
                     and tenant-aware routing by measured per-grid
                     latency

CLI: ``python -m elemental_tpu_torch.serve {run,smoke,chaos,fleet-smoke}``
and ``python -m elemental_tpu_torch.obs serve`` (the traced fleet).
Everything runs on ``cuda:0`` unless the caller passes a CPU grid (or
sets one as the default grid).
"""
from .admission import (REJECT_SCHEMA, AdmissionController, Bucket,
                        Deadline, SolveRequest, make_bucket, reject_doc,
                        validate_problem)
from .executor import (EXEC_SCHEMA, ExecutableCache, Executor, batch_slots,
                       ls_residual, pad_problem, pad_problem_ls, residual,
                       route_for, tune_token)
from .policy import (CLOSED, HALF_OPEN, OPEN, CircuitBreaker, RetryPolicy,
                     select_ladder)
from .service import RESULT_SCHEMA, SolverService
from .async_front import (AsyncSolverService, ServeFuture,
                          donation_safe, serve_async)
from .chaos import (CHAOS_SCHEMA, build_workload, chaos_matrix,
                    fleet_replay_identical, replay_identical,
                    run_async_cell, run_async_shutdown_cell, run_cell,
                    run_fleet_grid_loss_cell, run_fleet_saturation_cell,
                    run_qr_cell)
from .scheduler import DEFAULT_TENANT, FairScheduler, TenantQuota
from .fleet import (FleetFuture, GridWorker, RankSlot, SolverFleet,
                    partition_devices)

__all__ = [
    "REJECT_SCHEMA", "AdmissionController", "Bucket", "Deadline",
    "SolveRequest", "make_bucket", "reject_doc",
    "EXEC_SCHEMA", "ExecutableCache", "Executor", "batch_slots",
    "ls_residual", "pad_problem", "pad_problem_ls", "residual",
    "route_for", "tune_token",
    "CLOSED", "HALF_OPEN", "OPEN", "CircuitBreaker", "RetryPolicy",
    "select_ladder",
    "RESULT_SCHEMA", "SolverService",
    "AsyncSolverService", "ServeFuture", "serve_async",
    "donation_safe",
    "CHAOS_SCHEMA", "build_workload", "chaos_matrix", "replay_identical",
    "run_async_cell", "run_async_shutdown_cell", "run_cell", "run_qr_cell",
    "fleet_replay_identical", "run_fleet_grid_loss_cell",
    "run_fleet_saturation_cell",
    "DEFAULT_TENANT", "FairScheduler", "TenantQuota",
    "FleetFuture", "GridWorker", "RankSlot", "SolverFleet",
    "partition_devices",
    "validate_problem",
]
