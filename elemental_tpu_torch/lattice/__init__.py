"""Lattice tier (PyTorch port of ``elemental_tpu/lattice``; reference:
Elemental ``src/lattice/**``)."""
from .core import lll, is_lll_reduced, shortest_vector
