"""Sparse core + iterative solvers (PyTorch port of
``elemental_tpu/sparse``).

Reference: Elemental's sparse layer (``include/El/core/{Graph, DistGraph,
SparseMatrix, DistSparseMatrix, DistMap}/``) and the iterative pieces of
``reg_ldl``/``LeastSquares``.  The reference's sparse-direct multifrontal
factorization is out of scope, as in the JAX package: row-block COO
triplets with a deterministic segment-sum SpMV, matmul-free Krylov
solvers, and scipy's ``splu`` on the host for the sequential direct
solve.
"""
from .core import (sparse_to_coo, Graph, DistGraph, SparseMatrix, DistSparseMatrix,
                   DistMap, sparse_from_coo, dist_sparse_from_coo)
from .solvers import cg, cgls, gmres, sparse_direct_solve
