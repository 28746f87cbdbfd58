"""Structured comm plans (``comm_plan/v1``): totals, sites, JSON, diff.

The port's copy of the JAX package's ``analysis/plan.py``.  A
:class:`CommPlan` bundles the collective events of one driver call
(:mod:`.record_walk`: what the engine recorded, mapped to the collectives
the JAX lowering emits on a real grid) with the redistribution log of
:func:`elemental_tpu_torch.redist.engine.redist_trace`.  Its JSON
document is the JAX package's, key for key, so a port plan diffs
against the goldens under ``tests/golden/comm_plans/``:

    {"schema": "comm_plan/v1",
     "driver": "cholesky_lookahead", "grid": [2, 2],
     "n": 64, "nb": 16, "dtype": "float32",
     "static": true,                  # every collective ran: always true
     "totals": {"all_gather": {"count": 3, "bytes": 12288}, ...},
     "sites":  [{"prim", "axes", "axis_size", "shape", "dtype",
                 "count", "bytes"}, ...],          # aggregated, sorted
     "redistributes": {"[MC,MR]->[STAR,STAR]": 2, "panel_spread": 1, ...},
     "events": [...]}                 # full per-event detail (audit only)

Snapshots store the document WITHOUT the ``events`` list; ``diff_docs``
reports per-key mismatches so a failure names the collective that
changed.
"""
from __future__ import annotations

import dataclasses
import json

SCHEMA = "comm_plan/v1"


@dataclasses.dataclass
class CommPlan:
    """The extracted comm schedule of one traced driver call."""
    driver: str
    grid: tuple                      # (r, c)
    meta: dict                       # n, nb, dtype, extra driver knobs
    events: list                     # list[CollectiveEvent]
    redistributes: dict              # "{src}->{dst}" -> python call count

    # ---- aggregation -------------------------------------------------
    def totals(self) -> dict:
        """Per-collective ``{"count": N, "bytes": B}`` over all events."""
        out: dict = {}
        for ev in self.events:
            t = out.setdefault(ev.prim, {"count": 0, "bytes": 0})
            t["count"] += ev.count
            t["bytes"] += ev.total_bytes
        return dict(sorted(out.items()))

    def sites(self) -> list:
        """Events aggregated by (prim, axes, axis_size, shape, dtype)."""
        agg: dict = {}
        for ev in self.events:
            key = (ev.prim, ev.axes, ev.axis_size, ev.shape, ev.dtype)
            s = agg.setdefault(key, {"count": 0, "bytes": 0})
            s["count"] += ev.count
            s["bytes"] += ev.total_bytes
        rows = []
        for (prim, axes, size, shape, dtype), s in sorted(
                agg.items(), key=lambda kv: repr(kv[0])):
            rows.append({"prim": prim, "axes": list(axes), "axis_size": size,
                         "shape": list(shape), "dtype": dtype,
                         "count": s["count"], "bytes": s["bytes"]})
        return rows

    @property
    def static(self) -> bool:
        """True when every collective has a statically known trip count."""
        return all(ev.static for ev in self.events)

    def count(self, prim: str) -> int:
        return self.totals().get(prim, {}).get("count", 0)

    # ---- serialization ----------------------------------------------
    def to_doc(self, events: bool = True) -> dict:
        doc = {"schema": SCHEMA, "driver": self.driver,
               "grid": list(self.grid)}
        doc.update(self.meta)
        doc["static"] = self.static
        doc["totals"] = self.totals()
        doc["sites"] = self.sites()
        doc["redistributes"] = dict(sorted(self.redistributes.items()))
        if events:
            doc["events"] = [ev.to_doc() for ev in self.events]
        return doc

    def to_json(self, events: bool = True, indent: int = 1) -> str:
        return json.dumps(self.to_doc(events=events), indent=indent,
                          sort_keys=False)


def plan_from_parts(driver: str, grid, meta: dict, events, redist_log) -> CommPlan:
    """Assemble a CommPlan from walker events + an engine redist log."""
    redist: dict = {}
    for rec in redist_log:
        redist[rec.label] = redist.get(rec.label, 0) + 1
    return CommPlan(driver=driver, grid=tuple(grid), meta=dict(meta),
                    events=list(events), redistributes=redist)


def golden_doc(plan: CommPlan) -> dict:
    """The snapshot form: the plan document without per-event detail."""
    return plan.to_doc(events=False)


def diff_docs(golden: dict, current: dict) -> list:
    """Human-readable mismatch lines between two comm_plan/v1 documents.

    Compares schema/grid/meta scalars, per-collective totals, the
    aggregated sites table, and redistribute call counts.  Returns [] when
    the plans agree (the golden gate passes)."""
    lines: list = []
    for key in ("schema", "driver", "grid", "n", "nb", "dtype", "static"):
        if golden.get(key) != current.get(key):
            lines.append(f"{key}: golden={golden.get(key)!r} "
                         f"current={current.get(key)!r}")
    gt, ct = golden.get("totals", {}), current.get("totals", {})
    for prim in sorted(set(gt) | set(ct)):
        g, c = gt.get(prim), ct.get(prim)
        if g != c:
            lines.append(f"totals[{prim}]: golden={g} current={c}")
    gr, cr = golden.get("redistributes", {}), current.get("redistributes", {})
    for key in sorted(set(gr) | set(cr)):
        g, c = gr.get(key, 0), cr.get(key, 0)
        if g != c:
            lines.append(f"redistributes[{key}]: golden={g} current={c}")
    gs = set(_hashable_sites(golden))
    cs = set(_hashable_sites(current))

    def _row(t):
        return json.dumps(dict(t), sort_keys=True, default=str)

    for row in gs:
        if row not in cs:
            lines.append(f"site missing vs golden: {_row(row)}")
    for row in cs:
        if row not in gs:
            lines.append(f"site not in golden: {_row(row)}")
    return lines


def _hashable_sites(doc: dict):
    return [tuple(sorted(((k, tuple(v) if isinstance(v, list) else v)
                          for k, v in s.items())))
            for s in doc.get("sites", [])]
