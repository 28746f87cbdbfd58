"""Knob vocabularies of the tuner: the two the resilience ladder reads.

From ``elemental_tpu/tune/knobs.py``: the legal wire precisions
(``redist.quantize.COMM_PRECISIONS``) and LU panel strategies.
``certified_solve``'s rungs are written in these words.  The rest of the
tuner (search spaces, cache, cost model) is not ported yet.
"""
from ..redist.quantize import COMM_PRECISIONS  # noqa: F401  (None, bf16, int8)

#: LU panel strategies: the replicated partial-pivot panel and CALU's
#: tournament
LU_PANELS = ("classic", "calu")
