"""Redistribution engine (correct-first, through the global matrix)."""
from .engine import (redistribute, to_star_star, transpose_dist,
                     panel_spread, apply_fault, move_rows,
                     permute_rows_storage)
from .interior import interior_view, interior_update, vstack, hstack
