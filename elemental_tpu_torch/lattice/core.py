"""Lattice reduction: LLL (+ deep insertions) and a small-dim SVP helper.

PyTorch port of ``elemental_tpu/lattice/core.py`` (Elemental
``src/lattice/**``: ``El::LLL``, ``El::BKZ``, ``El::ShortestVector``).
Columns of B are the basis vectors, matching upstream.

Lattice reduction is an inherently sequential, precision-sensitive
scalar recurrence (upstream runs it on one rank in extended precision):
the sweep runs on the host in float64 on the gathered basis, and the
reduced basis + unimodular transform scatter back to [MC,MR] on the
grid's device.  The host sweep is the JAX package's, line for line, so
both packages return the same bases.
"""
from __future__ import annotations

import numpy as np

from ..core.dist import MC, MR
from ..core.distmatrix import DistMatrix, from_global, to_global


def _gso(B):
    """Gram-Schmidt mu + squared norms of B* (columns)."""
    m, n = B.shape
    mu = np.eye(n)
    Bs = B.astype(np.float64).copy()
    nrm2 = np.zeros(n)
    for k in range(n):
        v = B[:, k].astype(np.float64)
        for j in range(k):
            mu[k, j] = (B[:, k] @ Bs[:, j]) / max(nrm2[j], 1e-300)
            v = v - mu[k, j] * Bs[:, j]
        Bs[:, k] = v
        nrm2[k] = v @ v
    return mu, nrm2


def _lll_host(B, delta: float, eta: float = 0.51, deep: bool = False,
              max_sweeps: int = 10_000):
    """Floating LLL (Schnorr-Euchner loop) on a host array; returns
    (B_reduced, U, n_swaps, converged) with B_reduced = B @ U, U unimodular.
    ``converged`` is False iff the ``max_sweeps * n`` iteration cap fired
    before the sweep index reached n (the basis may then be unreduced)."""
    B = B.astype(np.float64).copy()
    m, n = B.shape
    U = np.eye(n)
    swaps = 0
    k = 1
    it = 0
    while k < n and it < max_sweeps * n:
        it += 1
        # one GSO per k-visit; size reduction updates row k of mu IN
        # PLACE (B* is invariant under column-k subtractions, and the
        # descending-j sweep leaves every |mu[k, j]| <= 1/2 exactly) --
        # the standard bookkeeping, O(n) per j instead of a fresh
        # O(m n^2) Gram-Schmidt per subtraction
        mu, nrm2 = _gso(B)
        for j in range(k - 1, -1, -1):
            q = np.round(mu[k, j])
            if abs(mu[k, j]) > eta and q != 0:
                B[:, k] -= q * B[:, j]
                U[:, k] -= q * U[:, j]
                mu[k, : j + 1] -= q * mu[j, : j + 1]
        if deep:
            # Schnorr-Euchner deep insertion: walk c = ||pi_i(b_k)||^2
            # down the positions; insert at the first i where
            # c < delta * ||b_i*||^2 (the plain swap is the i = k-1 case)
            c = float(B[:, k] @ B[:, k])
            ins = k
            for i in range(k):
                if c >= delta * nrm2[i]:
                    c -= mu[k, i] ** 2 * nrm2[i]
                else:
                    ins = i
                    break
            if ins < k:
                col = B[:, k].copy()
                ucol = U[:, k].copy()
                B[:, ins + 1:k + 1] = B[:, ins:k]
                U[:, ins + 1:k + 1] = U[:, ins:k]
                B[:, ins] = col
                U[:, ins] = ucol
                swaps += 1
                k = max(ins, 1)
                continue
            k += 1
            continue
        if nrm2[k] >= (delta - mu[k, k - 1] ** 2) * nrm2[k - 1]:
            k += 1
        else:
            B[:, [k - 1, k]] = B[:, [k, k - 1]]
            U[:, [k - 1, k]] = U[:, [k, k - 1]]
            swaps += 1
            k = max(k - 1, 1)
    return B, U, swaps, k >= n


def lll(B: DistMatrix, delta: float = 0.99, eta: float = 0.51,
        deep: bool = False, max_sweeps: int = 10_000):
    """LLL-reduce the columns of B (``El::LLL``).  Returns
    (B_reduced [MC,MR], U [MC,MR] unimodular, info) with
    ``B_reduced = B U`` and the reduced basis satisfying the
    size-reduction (|mu_kj| <= eta) and Lovasz (delta) conditions.

    ``info["converged"]`` reports whether the returned basis actually IS
    LLL-reduced: True on normal termination; when the ``max_sweeps * n``
    iteration cap fires mid-sweep, :func:`is_lll_reduced` is run on the
    result (the cap can land exactly at completion) instead of silently
    handing back a possibly-unreduced basis."""
    Bn = to_global(B).cpu().numpy().astype(np.float64)
    R, U, swaps, converged = _lll_host(Bn, delta, eta, deep, max_sweeps)
    if not converged:
        converged = is_lll_reduced(R, delta, eta)
    g = B.grid
    info = {"swaps": swaps,
            "first_norm": float(np.linalg.norm(R[:, 0])),
            "converged": bool(converged)}
    return (from_global(R.astype(np.asarray(Bn).dtype), MC, MR, grid=g),
            from_global(U, MC, MR, grid=g), info)


def is_lll_reduced(B, delta: float = 0.99, eta: float = 0.51) -> bool:
    """Check the size-reduction + Lovasz conditions (host-side)."""
    Bn = to_global(B).cpu().numpy().astype(np.float64) \
        if isinstance(B, DistMatrix) else np.asarray(B, np.float64)
    mu, nrm2 = _gso(Bn)
    n = Bn.shape[1]
    for k in range(1, n):
        for j in range(k):
            if abs(mu[k, j]) > eta + 1e-9:
                return False
        if nrm2[k] < (delta - mu[k, k - 1] ** 2) * nrm2[k - 1] - 1e-9:
            return False
    return True


def shortest_vector(B: DistMatrix, delta: float = 0.99,
                    enum_radius: int = 2):
    """Short lattice vector (``El::ShortestVector`` approximation): LLL
    first, then exhaustive enumeration of small integer combinations of
    the first few reduced vectors (exact SVP enumeration is exponential;
    upstream's is too).  Returns (v host vector, norm)."""
    R, U, info = lll(B, delta)
    Rn = to_global(R).cpu().numpy()
    n = Rn.shape[1]
    best = Rn[:, 0]
    bestn = np.linalg.norm(best)
    kdim = min(n, 5)
    from itertools import product
    for coef in product(range(-enum_radius, enum_radius + 1), repeat=kdim):
        if not any(coef):
            continue
        v = Rn[:, :kdim] @ np.asarray(coef, np.float64)
        nv = np.linalg.norm(v)
        if 1e-9 < nv < bestn:
            best, bestn = v, nv
    return best, float(bestn)
