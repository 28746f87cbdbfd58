"""Redistribution subsystem: the engine (:mod:`.engine`), the one-shot
plan compiler (:mod:`.plan`) and the wire codecs (:mod:`.quantize`)."""
from .engine import (redistribute, to_star_star, transpose_dist,
                     panel_spread, apply_fault, move_rows,
                     permute_rows_storage, contract, redist_counts,
                     redist_trace, add_redist_observer, fault_injection,
                     set_fault_step, RedistRecord, REDIST_PATHS)
from .interior import interior_view, interior_update, vstack, hstack
from .plan import RedistPlan, compile_plan, comm_axes_for
