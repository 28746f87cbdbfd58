"""Collective events from a recorded run: the twin of ``jaxpr_walk.py``.

The JAX package walks a closed jaxpr for its collective equations.  The
port has no jaxpr: its drivers run, and the redistribution engine records
every public entry (:class:`~..redist.engine.RedistRecord`) while the
drivers announce the collectives they issue themselves
(:func:`~..redist.engine.note_collective`, CALU's row-block psum).  This
module maps each record to the collectives the JAX lowering emits for it
on a real grid (:func:`~..redist.engine.record_sites`: primitive, mesh
axes, participants, operand block, wire dtype, ring-model bytes) and
emits one :class:`CollectiveEvent` per collective.

Every event ran, so every event is ``static`` with ``count`` 1 and none
is ``conditional``: a plan's ``static`` is always true, as it is for all
the JAX package's goldens.  The scope is the JAX walker's: collectives
GSPMD inserts for storage-level ops on sharded arrays are not in a
jaxpr, and the port does not count them either.

``path`` names the record (its label and index in the run) and the hop
within it, where the JAX walker gives the nesting of ``pjit`` /
``shard_map`` scopes.
"""
from __future__ import annotations

import dataclasses
from collections import Counter

from ..redist.engine import record_sites, ring_bytes

#: collective primitive names (the JAX walker's).
COLLECTIVE_PRIMS = (
    "all_gather",
    "psum",
    "reduce_scatter",
    "ppermute",
    "all_to_all",
)


@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One collective a recorded run issues on a real grid."""
    prim: str                   # one of COLLECTIVE_PRIMS
    axes: tuple                 # mesh axis names communicated over
    axis_size: int              # participants
    shape: tuple                # operand (per-rank) shape
    dtype: str                  # wire dtype name
    bytes_per_call: int         # ring-model bytes received per rank
    path: tuple                 # (record label#index, hop[j])
    count: int = 1              # every event ran once
    static: bool = True         # every event ran: its trip count is known
    conditional: bool = False

    @property
    def total_bytes(self) -> int:
        return self.bytes_per_call * self.count

    def to_doc(self) -> dict:
        d = dataclasses.asdict(self)
        d["axes"] = list(self.axes)
        d["shape"] = list(self.shape)
        d["path"] = list(self.path)
        return d


def estimate_bytes(prim: str, nbytes: int, axis_size: int) -> int:
    """Ring-algorithm per-rank received bytes of one collective (the JAX
    walker's ``estimate_bytes``; the engine's :func:`ring_bytes`)."""
    return ring_bytes(prim, nbytes, axis_size)


def _event(site, path) -> CollectiveEvent:
    return CollectiveEvent(prim=site.prim, axes=tuple(site.axes),
                           axis_size=site.axis_size, shape=tuple(site.shape),
                           dtype=site.dtype, bytes_per_call=site.bytes,
                           path=tuple(path))


def collect_events(records, notes=()) -> list:
    """One :class:`CollectiveEvent` per collective of a recorded run:
    the sites of every redistribution record, then every driver-level
    note (a :class:`~..redist.engine.CollectiveSite`)."""
    out = []
    for i, rec in enumerate(records):
        for j, site in enumerate(record_sites(rec)):
            out.append(_event(site, (f"{rec.label}#{i}", f"hop[{j}]")))
    for k, site in enumerate(notes):
        out.append(_event(site, (f"driver:{site.prim}#{k}",)))
    return out


def count_record_calls(records, label: str) -> int:
    """Number of recorded entries labelled ``label`` (e.g.
    ``'panel_spread'`` or ``'[MC,MR]->[STAR,STAR]'``) -- the twin of the
    JAX walker's ``count_pjit_calls``, which counts ``pjit`` call sites."""
    return Counter(rec.label for rec in records)[label]


def find_loop_invariant_collectives(records) -> list:
    """Redistributions that moved unchanged data twice: two records of one
    run on the same source tensor (``in_id``), to the same target, with
    the tensor's ``_version`` unchanged between them -- the second could
    reuse the first's output (the run-time form of the JAX walker's
    loop-invariant collective, hoistable out of the loop).  Returns
    ``(label, (first index, repeat index))`` tuples; entries that issue no
    collective on their grid are not reported."""
    seen: dict = {}
    found = []
    for i, rec in enumerate(records):
        if rec.kind not in ("redistribute", "panel_spread"):
            continue
        key = (rec.in_id, rec.kind, rec.dst, rec.path, rec.wire_dtype)
        prev = seen.get(key)
        if prev is not None and prev[1] == rec.in_version \
                and rec.in_version >= 0 and record_sites(rec):
            found.append((rec.label, (prev[0], i)))
        seen[key] = (i, rec.in_version)
    return found
