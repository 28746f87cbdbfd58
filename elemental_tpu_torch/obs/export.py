"""Exporters: Chrome-trace/Perfetto ``trace.json`` from a Tracer run.

PyTorch port of ``elemental_tpu/obs/export.py``.  ``chrome_trace_doc``
renders one :class:`~.tracer.Tracer` into the Chrome Trace Event
JSON-object format, which Perfetto (https://ui.perfetto.dev) and
chrome://tracing both load directly:

  * spans are duration events (``ph: "X"``, micros since the run origin);
  * the driver -> step -> phase nesting is laid out as ONE TRACK PER
    PHASE LANE: track 0 carries the synthesized driver spans (one per
    tick channel) plus any explicit ``tracer.span`` blocks, track 1 the
    synthesized per-step spans, and each phase name gets its own track
    (``diag``/``panel``/``swap``/... in the canonical PHASES order,
    unseen names appended) so overlap between lanes is visible;
  * collectives are instant events (``ph: "i"``) on a dedicated
    ``collectives`` track, with src->dst label, global shape, dtype and
    ring-model bytes in ``args``.

The document carries a top-level ``"schema": "obs_chrome_trace/v1"`` key;
run metadata rides ``otherData``.  For the same records it equals the JAX
package's document.  Tracks are keyed by the tracer's per-thread token
(:mod:`.tracer`), not by ``threading.get_ident()``: an ident that Python
hands to a later thread no longer merges two workers' tracks.

``phase_timings_to_chrome`` converts a ``phase_timings/v1`` document
(which records durations but no timestamps) into the same trace format by
laying the steps out sequentially -- ``python -m elemental_tpu_torch.obs
export`` is the CLI.
"""
from __future__ import annotations

import json

from .phase_timer import PHASES, SCHEMA as PHASE_SCHEMA
from .tracer import Tracer, _driver_calls

CHROME_SCHEMA = "obs_chrome_trace/v1"

_PID = 0
_TID_DRIVER = 0
_TID_STEP = 1
_FIRST_PHASE_TID = 2


def _lanes(phase_names) -> dict:
    """Stable phase-name -> tid map: canonical order first, extras after."""
    lanes: dict = {}
    tid = _FIRST_PHASE_TID
    for p in PHASES:
        if p in phase_names:
            lanes[p] = tid
            tid += 1
    for p in sorted(phase_names):
        if p not in lanes:
            lanes[p] = tid
            tid += 1
    return lanes


def _meta_events(lanes: dict, have_comms: bool,
                 have_instants: bool = False) -> list:
    evs = [{"ph": "M", "pid": _PID, "tid": _TID_DRIVER, "name": "thread_name",
            "args": {"name": "drivers"}},
           {"ph": "M", "pid": _PID, "tid": _TID_STEP, "name": "thread_name",
            "args": {"name": "steps"}}]
    for p, tid in sorted(lanes.items(), key=lambda kv: kv[1]):
        evs.append({"ph": "M", "pid": _PID, "tid": tid, "name": "thread_name",
                    "args": {"name": f"phase:{p}"}})
    if have_comms:
        evs.append({"ph": "M", "pid": _PID, "tid": _comm_tid(lanes),
                    "name": "thread_name", "args": {"name": "collectives"}})
    if have_instants:
        evs.append({"ph": "M", "pid": _PID,
                    "tid": _instant_tid(lanes, have_comms),
                    "name": "thread_name", "args": {"name": "events"}})
    return evs


def _comm_tid(lanes: dict) -> int:
    return (max(lanes.values()) + 1) if lanes else _FIRST_PHASE_TID


def _instant_tid(lanes: dict, have_comms: bool) -> int:
    return _comm_tid(lanes) + (1 if have_comms else 0)


def _group_by_thread(tracer: Tracer) -> tuple:
    """Partition a tracer's records by originating thread.

    Records with no thread attribution (``thread=0``) fold into the
    tracer's HOME thread, which keeps the single-thread layout (driver
    track 0, steps 1, phase lanes...) stable.  Returns
    ``(home_token, {token: group})`` where each group holds
    ``spans``/``phases``/``comms``/``instants`` lists plus a display
    ``name`` and first-event time for deterministic track ordering.
    """
    home = getattr(tracer, "home_thread", 0)
    groups: dict = {}

    def add(kind, ev, t):
        th = getattr(ev, "thread", 0) or home
        g = groups.get(th)
        if g is None:
            g = groups[th] = {"spans": [], "phases": [], "comms": [],
                              "instants": [], "name": "", "first": t}
        g[kind].append(ev)
        g["first"] = min(g["first"], t)
        if not g["name"]:
            g["name"] = getattr(ev, "thread_name", "") or ""

    for s in tracer.spans:
        add("spans", s, s.t0)
    for r in tracer.phases:
        add("phases", r, r.t0)
    for ev in tracer.comms:
        add("comms", ev, ev.t)
    for ev in getattr(tracer, "instants", ()):
        add("instants", ev, ev.t)
    return home, groups


def chrome_trace_doc(tracer: Tracer, **meta) -> dict:
    """Render a tracer's spans/phases/collectives as a Chrome trace.

    Tracks are keyed by ORIGINATING THREAD (its token): the tracer's home
    thread keeps the fixed layout (driver track, step track, one
    lane per phase, collectives, events); every other recording thread
    -- e.g. each fleet grid worker -- gets its own contiguous track
    block labelled by its thread name, so a 2-grid fleet trace renders
    as one track group per worker instead of interleaved garbage.

    Instants carrying a ``flow`` attr (request lifecycle marks) are
    additionally linked into Chrome-trace FLOW events (``ph: "s"`` at
    the first mark, ``"t"`` steps, ``"f"`` at the last) sharing
    ``id=<flow>``, which Perfetto draws as arrows hopping a request
    across grid-worker tracks.
    """
    times = ([r.t0 for r in tracer.phases]
             + [s.t0 for s in tracer.spans]
             + [ev.t for ev in tracer.comms]
             + [ev.t for ev in getattr(tracer, "instants", ())])
    origin = min(times) if times else 0.0

    def us(t: float) -> float:
        return round((t - origin) * 1e6, 3)

    home, groups = _group_by_thread(tracer)
    home_g = groups.get(home, {"spans": [], "phases": [], "comms": [],
                               "instants": [], "name": "", "first": 0.0})
    lanes = _lanes({r.phase for r in home_g["phases"]})
    events = _meta_events(lanes, bool(home_g["comms"]),
                          bool(home_g["instants"]))
    placed_instants: list = []   # (instant, tid) for flow-event linking

    def emit_group(g, tid_span, tid_step, phase_lanes, tid_comm, tid_inst):
        for call, driver, t0, t1, steps in _driver_calls(g["phases"]):
            events.append({"ph": "X", "pid": _PID, "tid": tid_span,
                           "name": driver, "ts": us(t0),
                           "dur": round((t1 - t0) * 1e6, 3),
                           "args": {"call": call, "steps": len(steps)}})
        for s in g["spans"]:
            t1 = s.t1 if s.t1 is not None else s.t0
            events.append({"ph": "X", "pid": _PID, "tid": tid_span,
                           "name": s.name, "ts": us(s.t0),
                           "dur": round((t1 - s.t0) * 1e6, 3),
                           "args": {"depth": s.depth, **s.attrs}})
        steps_agg: dict = {}
        for r in g["phases"]:
            key = (r.call, r.step)
            cur = steps_agg.get(key)
            if cur is None:
                steps_agg[key] = [r.driver, r.t0, r.t1]
            else:
                cur[1] = min(cur[1], r.t0)
                cur[2] = max(cur[2], r.t1)
        for (call, step), (driver, t0, t1) in sorted(steps_agg.items()):
            events.append({"ph": "X", "pid": _PID, "tid": tid_step,
                           "name": f"{driver}[{step}]", "ts": us(t0),
                           "dur": round((t1 - t0) * 1e6, 3),
                           "args": {"call": call, "step": step}})
        for r in g["phases"]:
            events.append({"ph": "X", "pid": _PID,
                           "tid": phase_lanes[r.phase],
                           "name": r.phase, "ts": us(r.t0),
                           "dur": round(r.seconds * 1e6, 3),
                           "args": {"driver": r.driver, "step": r.step,
                                    "call": r.call}})
        for ev in g["comms"]:
            events.append({"ph": "i", "s": "t", "pid": _PID,
                           "tid": tid_comm,
                           "name": ev.label, "ts": us(ev.t),
                           "args": {"kind": ev.kind,
                                    "gshape": list(ev.gshape),
                                    "dtype": ev.dtype, "bytes": ev.bytes,
                                    "wire_dtype":
                                    getattr(ev, "wire_dtype", "")
                                    or ev.dtype,
                                    "wire_bytes":
                                    getattr(ev, "wire_bytes", 0)
                                    or ev.bytes,
                                    "driver": ev.driver, "span": ev.span}})
        for ev in g["instants"]:
            events.append({"ph": "i", "s": "t", "pid": _PID,
                           "tid": tid_inst,
                           "name": ev.name, "ts": us(ev.t),
                           "args": dict(ev.attrs)})
            placed_instants.append((ev, tid_inst))

    # home thread: the fixed layout
    emit_group(home_g, _TID_DRIVER, _TID_STEP, lanes,
               _comm_tid(lanes), _instant_tid(lanes, bool(home_g["comms"])))
    next_tid = _instant_tid(lanes, bool(home_g["comms"])) \
        + (1 if home_g["instants"] else 0)

    # one track block per foreign recording thread (grid workers, ...)
    foreign = sorted((th for th in groups if th != home),
                     key=lambda th: (groups[th]["first"], th))
    for th in foreign:
        g = groups[th]
        label = g["name"] or f"thread-{th}"
        tid_span = next_tid
        next_tid += 1
        events.append({"ph": "M", "pid": _PID, "tid": tid_span,
                       "name": "thread_name", "args": {"name": label}})
        if g["phases"]:
            tid_step = next_tid
            next_tid += 1
            events.append({"ph": "M", "pid": _PID, "tid": tid_step,
                           "name": "thread_name",
                           "args": {"name": f"{label} steps"}})
            phase_lanes = {}
            for p in sorted({r.phase for r in g["phases"]}):
                phase_lanes[p] = next_tid
                events.append({"ph": "M", "pid": _PID, "tid": next_tid,
                               "name": "thread_name",
                               "args": {"name": f"{label} phase:{p}"}})
                next_tid += 1
        else:
            tid_step, phase_lanes = tid_span, {}
        if g["comms"]:
            tid_comm = next_tid
            next_tid += 1
            events.append({"ph": "M", "pid": _PID, "tid": tid_comm,
                           "name": "thread_name",
                           "args": {"name": f"{label} collectives"}})
        else:
            tid_comm = tid_span
        if g["instants"]:
            tid_inst = next_tid
            next_tid += 1
            events.append({"ph": "M", "pid": _PID, "tid": tid_inst,
                           "name": "thread_name",
                           "args": {"name": f"{label} events"}})
        else:
            tid_inst = tid_span
        emit_group(g, tid_span, tid_step, phase_lanes, tid_comm, tid_inst)

    # flow events: link same-``flow`` lifecycle instants across tracks
    flows: dict = {}
    for i, (ev, tid) in enumerate(placed_instants):
        fid = ev.attrs.get("flow") if isinstance(ev.attrs, dict) else None
        if fid is None:
            continue
        flows.setdefault(fid, []).append((ev.t, i, ev, tid))
    for fid in sorted(flows, key=str):
        chain = sorted(flows[fid])
        if len(chain) < 2:
            continue
        for j, (t, _, ev, tid) in enumerate(chain):
            ph = "s" if j == 0 else ("f" if j == len(chain) - 1 else "t")
            events.append({"ph": ph, "pid": _PID, "tid": tid,
                           "name": "serve:req", "cat": "lifecycle",
                           "id": str(fid), "ts": us(t)})
    return {"schema": CHROME_SCHEMA, "traceEvents": events,
            "displayTimeUnit": "ms", "otherData": dict(meta)}


def phase_timings_to_chrome(doc: dict, **meta) -> dict:
    """Synthesize a Chrome trace from a ``phase_timings/v1`` document.

    The phase-timings schema records per-(step, phase) DURATIONS but no
    timestamps, so the steps are laid out back-to-back in listed order
    (phases within a step in canonical order) -- lane structure and
    relative widths are faithful, absolute placement is synthetic
    (flagged in ``otherData.synthesized``)."""
    if doc.get("schema") != PHASE_SCHEMA:
        raise ValueError(f"expected a {PHASE_SCHEMA} document, got "
                         f"schema={doc.get('schema')!r}")
    driver = str(doc.get("driver", "driver"))
    phase_names = set()
    for srec in doc.get("steps", []):
        phase_names |= set(srec) - {"step"}
    lanes = _lanes(phase_names)
    events = _meta_events(lanes, have_comms=False)
    order = [p for p in PHASES if p in phase_names] \
        + sorted(phase_names - set(PHASES))
    t = 0.0
    for srec in doc.get("steps", []):
        step_t0 = t
        for p in order:
            if p not in srec:
                continue
            dur = float(srec[p])
            events.append({"ph": "X", "pid": _PID, "tid": lanes[p],
                           "name": p, "ts": round(t * 1e6, 3),
                           "dur": round(dur * 1e6, 3),
                           "args": {"driver": driver, "step": srec["step"]}})
            t += dur
        events.append({"ph": "X", "pid": _PID, "tid": _TID_STEP,
                       "name": f"{driver}[{srec['step']}]",
                       "ts": round(step_t0 * 1e6, 3),
                       "dur": round((t - step_t0) * 1e6, 3),
                       "args": {"step": srec["step"]}})
    events.append({"ph": "X", "pid": _PID, "tid": _TID_DRIVER, "name": driver,
                   "ts": 0.0, "dur": round(t * 1e6, 3),
                   "args": {"total_seconds": doc.get("total_seconds")}})
    other = {"synthesized": True,
             "source_schema": PHASE_SCHEMA}
    for k in ("driver", "n", "nb", "device", "lookahead"):
        if k in doc:
            other[k] = doc[k]
    other.update(meta)
    return {"schema": CHROME_SCHEMA, "traceEvents": events,
            "displayTimeUnit": "ms", "otherData": other}


def write_json(path: str, doc: dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
