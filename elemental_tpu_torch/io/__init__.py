"""IO layer (PyTorch port of ``elemental_tpu/io``): print, write, read,
checkpoint, Matrix Market, display.

Reference: Elemental ``src/io/``.
"""
from .core import (print_matrix, write_matrix, read_matrix, checkpoint,
                   restore, write_matrix_market, read_matrix_market,
                   display, spy)
