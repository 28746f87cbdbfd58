"""Windowed per-(tenant, grid, bucket) SLO monitoring -> ``serve_slo/v1``.

PyTorch port of ``elemental_tpu/obs/slo.py`` (host-only).  The fleet's
online tail-latency/error/shed view: a count-based sliding window
(last ``window`` outcomes per series key) of every ``serve_result/v1`` /
``serve_reject/v1`` the fleet settles, from which
:meth:`SLOMonitor.snapshot` computes

  * nearest-rank latency percentiles (p50/p95/p99, milliseconds, over
    completed solves -- sheds carry no latency);
  * ``error_rate`` (non-``ok`` completions / completions) and
    ``shed_rate`` (rejects / all outcomes);
  * BURN RATES against the configured :class:`SLOTarget`: how fast each
    series is consuming its error budget, normalized so 1.0 = exactly
    on target and >1.0 = burning faster than the SLO allows::

        burn_latency = frac(latency > p99_ms) / (1 - latency_objective)
        burn_error   = error_rate / error_budget
        burn_shed    = shed_rate  / shed_budget

A count-based window (rather than wall-clock) keeps snapshots
deterministic under the chaos harness's virtual clocks.  ``snapshot``
emits the STABLE ``serve_slo/v1`` document (series sorted by key) and
mirrors the headline numbers as gauges (``serve_slo_p99_ms``,
``serve_slo_burn_latency``, ...) on the current metrics registry.
"""
from __future__ import annotations

import collections
import dataclasses
import threading

from . import metrics as _metrics

SCHEMA = "serve_slo/v1"


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One series' objectives: latency target + budgets."""
    p99_ms: float = 1000.0           # latency objective threshold
    latency_objective: float = 0.99  # fraction that must beat p99_ms
    error_budget: float = 0.01       # allowed non-ok completion fraction
    shed_budget: float = 0.05        # allowed reject fraction

    def to_doc(self) -> dict:
        return {"p99_ms": self.p99_ms,
                "latency_objective": self.latency_objective,
                "error_budget": self.error_budget,
                "shed_budget": self.shed_budget}


DEFAULT_TARGET = SLOTarget()


def _pctl(sorted_vals: list, q: float):
    """Nearest-rank percentile over an ascending list (None if empty)."""
    if not sorted_vals:
        return None
    i = max(0, min(len(sorted_vals) - 1,
                   int(-(-q * len(sorted_vals) // 1)) - 1))
    return sorted_vals[i]


def _bucket_label(bucket) -> str:
    if hasattr(bucket, "key"):
        bucket = bucket.key()
    if isinstance(bucket, (tuple, list)):
        return "x".join(str(b) for b in bucket)
    return str(bucket)


class SLOMonitor:
    """Sliding-window outcome tracker keyed by (tenant, grid, bucket)."""

    def __init__(self, *, window: int = 256, target: SLOTarget | None = None,
                 targets: dict | None = None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self.target = target if target is not None else DEFAULT_TARGET
        #: per-tenant target overrides {tenant: SLOTarget}
        self.targets = dict(targets or {})
        self._series: dict = {}   # key -> deque[(latency_ms|None, status)]
        self._lock = threading.Lock()

    def target_for(self, tenant: str) -> SLOTarget:
        return self.targets.get(tenant, self.target)

    # ---- feeding -----------------------------------------------------
    def record(self, doc: dict) -> None:
        """Ingest one serve_result/serve_reject document."""
        rejected = "reason" in doc and "status" not in doc
        status = "shed" if rejected else str(doc.get("status", "ok"))
        lat = None if rejected else float(doc.get("latency_s") or 0.0) * 1e3
        key = (str(doc.get("tenant") or "default"),
               str(doc.get("grid") or "-"),
               _bucket_label(doc.get("bucket")))
        with self._lock:
            dq = self._series.get(key)
            if dq is None:
                dq = self._series[key] = collections.deque(
                    maxlen=self.window)
            dq.append((lat, status))

    # ---- snapshotting ------------------------------------------------
    def snapshot(self, *, gauges: bool = True, **meta) -> dict:
        """The stable ``serve_slo/v1`` doc; mirrors headline numbers as
        gauges on the current metrics registry unless ``gauges=False``."""
        with self._lock:
            series = {k: list(dq) for k, dq in self._series.items()}
        rows = []
        for key in sorted(series):
            tenant, grid, bucket = key
            outcomes = series[key]
            lats = sorted(l for l, s in outcomes if l is not None)
            n = len(outcomes)
            sheds = sum(1 for _, s in outcomes if s == "shed")
            done = n - sheds
            errors = sum(1 for _, s in outcomes
                         if s not in ("ok", "shed"))
            tgt = self.target_for(tenant)
            p99 = _pctl(lats, 0.99)
            over = sum(1 for l in lats if l > tgt.p99_ms)
            frac_over = (over / len(lats)) if lats else 0.0
            err_rate = (errors / done) if done else 0.0
            shed_rate = (sheds / n) if n else 0.0
            burn = {
                "latency": frac_over / max(1e-12,
                                           1.0 - tgt.latency_objective),
                "error": err_rate / max(1e-12, tgt.error_budget),
                "shed": shed_rate / max(1e-12, tgt.shed_budget),
            }
            row = {"tenant": tenant, "grid": grid, "bucket": bucket,
                   "count": n, "ok": done - errors, "errors": errors,
                   "sheds": sheds,
                   "p50_ms": _pctl(lats, 0.50), "p95_ms": _pctl(lats, 0.95),
                   "p99_ms": p99, "error_rate": err_rate,
                   "shed_rate": shed_rate, "target": tgt.to_doc(),
                   "burn": burn}
            rows.append(row)
            if gauges:
                labels = {"tenant": tenant, "grid": grid, "bucket": bucket}
                if p99 is not None:
                    _metrics.set_gauge("serve_slo_p99_ms", p99, **labels)
                _metrics.set_gauge("serve_slo_burn_latency",
                                   burn["latency"], **labels)
                _metrics.set_gauge("serve_slo_burn_error", burn["error"],
                                   **labels)
                _metrics.set_gauge("serve_slo_burn_shed", burn["shed"],
                                   **labels)
        doc = {"schema": SCHEMA, "window": self.window, "series": rows}
        doc.update(meta)
        return doc

    # ---- headline reads ----------------------------------------------
    def per_tenant_p99_ms(self) -> dict:
        """{tenant: p99 ms over that tenant's pooled window outcomes}."""
        with self._lock:
            series = {k: list(dq) for k, dq in self._series.items()}
        pools: dict = {}
        for (tenant, _, _), outcomes in series.items():
            pools.setdefault(tenant, []).extend(
                l for l, s in outcomes if l is not None)
        return {t: _pctl(sorted(ls), 0.99)
                for t, ls in sorted(pools.items()) if ls}

    def worst_p99_ms(self):
        """Max per-tenant p99 (the single gateable scalar), or None."""
        per = self.per_tenant_p99_ms()
        return max(per.values()) if per else None
