"""Control-theory solvers: Sylvester, Lyapunov, Riccati.

PyTorch port of ``elemental_tpu/control/core.py`` (Elemental
``src/control/``: ``El::Sylvester``, ``El::Lyapunov``, ``El::Ricatti``),
all built on the matrix sign function of a structured block matrix
(Roberts' method): the sign iteration is
:func:`elemental_tpu_torch.lapack.funcs.sign` (scaled Newton, LU solves),
and the blocks are assembled and extracted with the interior embed and
extract primitives.
"""
from __future__ import annotations

from ..core.dist import MC, MR
from ..core.distmatrix import DistMatrix
from ..redist.engine import redistribute, transpose_dist
from ..redist.interior import interior_view, interior_update, vstack, _blank
from ..blas.level1 import shift_diagonal
from ..blas.level3 import _check_mcmr
from ..lapack.funcs import sign as _sign
from ..lapack.qr import least_squares


def sylvester(A: DistMatrix, B: DistMatrix, C: DistMatrix,
              nb: int | None = None, precision=None) -> DistMatrix:
    """Solve ``A X + X B = C`` (``El::Sylvester``) via
    ``sign([[A, -C], [0, -B]]) = [[-I, 2X], [0, I]]``.

    Requires the spectra of A and -B to be separated by the imaginary axis
    (the classical stability assumption: A and B stable)."""
    _check_mcmr(A, B, C)
    m = A.gshape[0]
    n = B.gshape[0]
    if A.gshape != (m, m) or B.gshape != (n, n) or C.gshape != (m, n):
        raise ValueError(f"incompatible shapes {A.gshape},{B.gshape},"
                         f"{C.gshape}")
    W = _blank(m + n, m + n, A)
    W = interior_update(W, A, (0, 0))
    W = interior_update(W, C.with_local(-C.local), (0, m))
    W = interior_update(W, B.with_local(-B.local), (m, m))
    S = _sign(W, nb=nb, precision=precision)
    S12 = interior_view(S, (0, m), (m, m + n))
    return S12.with_local(0.5 * S12.local)


def lyapunov(A: DistMatrix, C: DistMatrix, nb: int | None = None,
             precision=None) -> DistMatrix:
    """Solve ``A X + X A^H = C`` (``El::Lyapunov``); A stable."""
    Ah = redistribute(transpose_dist(A, conj=True), MC, MR)
    return sylvester(A, Ah, C, nb=nb, precision=precision)


def riccati(A: DistMatrix, G: DistMatrix, Q: DistMatrix,
            nb: int | None = None, precision=None) -> DistMatrix:
    """Stabilizing solution of the continuous algebraic Riccati equation
    ``A^H X + X A + Q - X G X = 0`` (``El::Ricatti``): the stable invariant
    subspace of the Hamiltonian ``H = [[A, -G], [-Q, -A^H]]`` satisfies
    ``(sign(H) + I) [I; X] = 0``; X is recovered from the (consistent)
    overdetermined system ``[S12; S22 + I] X = -[S11 + I; S21]``."""
    _check_mcmr(A, G, Q)
    n = A.gshape[0]
    Ah = redistribute(transpose_dist(A, conj=True), MC, MR)
    H = _blank(2 * n, 2 * n, A)
    H = interior_update(H, A, (0, 0))
    H = interior_update(H, G.with_local(-G.local), (0, n))
    H = interior_update(H, Q.with_local(-Q.local), (n, 0))
    H = interior_update(H, Ah.with_local(-Ah.local), (n, n))
    S = _sign(H, nb=nb, precision=precision)
    S11 = interior_view(S, (0, n), (0, n))
    S12 = interior_view(S, (0, n), (n, 2 * n))
    S21 = interior_view(S, (n, 2 * n), (0, n))
    S22 = interior_view(S, (n, 2 * n), (n, 2 * n))
    M = vstack(S12, shift_diagonal(S22, 1))
    R = vstack(shift_diagonal(S11, 1), S21)
    return least_squares(M, R.with_local(-R.local), nb=nb,
                         precision=precision)
