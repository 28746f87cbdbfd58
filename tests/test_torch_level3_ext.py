"""The rest of the port's level-3 BLAS (``her2k``, ``syr2k``, ``trr2k``,
``hemm``, ``symm``, ``multishift_trsm``, ``quasi_trsm``) against
``elemental_tpu``: the inputs of ``tests/blas/test_level3_ext.py`` and
``tests/lapack/test_variants.py`` (made from the same seeds with numpy)
go through both packages, the JAX package once per case on a 1x1 grid
and the port on 1x1, 2x2 and 2x4 grids.  Results agree to 1e-12 of the
largest entry; the other triangle of a rank-2k update is bit-equal to C;
every result meets the JAX tests' own oracles.

The JAX references run on a 1x1 JAX grid: on its 8 virtual CPU devices a
JAX call that dispatches many small sharded computations in turn can
starve XLA's in-process all-reduce rendezvous when the host is loaded
(several test workers), which aborts the process after 40 s
(``rendezvous.cc``: "Termination timeout ... exceeded"); one device has
no rendezvous.
"""
import functools

import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]


def _mat(rng, m, n, dtype):
    A = rng.normal(size=(m, n))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        A = A + 1j * rng.normal(size=(m, n))
    return A.astype(dtype)


def _tri(x, uplo, k=0):
    return np.tril(x, k) if uplo == "L" else np.triu(x, -k)


def _jgrid():
    return el.Grid(jax.devices()[:1], height=1)


def _agree(got, want, tol=1e-12):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1))


class _Pkg:
    """One package's entry points with the same call shape: ``dm`` lays a
    global numpy array out on the package's grid, ``g`` gathers it back."""

    def __init__(self, mod, grid):
        self.mod, self.grid = mod, grid

    def dm(self, F):
        return self.mod.from_global(F, self.mod.MC, self.mod.MR,
                                    grid=self.grid)

    def g(self, A):
        out = self.mod.to_global(A)
        return out.numpy() if hasattr(out, "numpy") else np.asarray(out)


def _jax_pkg():
    return _Pkg(el, _jgrid())


def _port_pkg(rc):
    return _Pkg(et, et.Grid(*rc, device="cpu"))


# ---------------------------------------------------------------------
# the cases: each returns (result, truth) for one package
# ---------------------------------------------------------------------

def _her2k(P, uplo, orient):
    rng = np.random.default_rng(0)
    A = _mat(rng, 10, 6, np.complex128) if orient == "N" \
        else _mat(rng, 6, 10, np.complex128)
    B = A * 0 + _mat(rng, *A.shape, np.complex128)
    C0 = _mat(rng, 10, 10, np.complex128)
    a = 0.7 - 0.2j
    out = P.mod.her2k(uplo, P.dm(A), P.dm(B), alpha=a, beta=0.5, C=P.dm(C0),
                      orient=orient, nb=4)
    opA = A if orient == "N" else A.conj().T
    opB = B if orient == "N" else B.conj().T
    full = a * opA @ opB.conj().T + np.conj(a) * opB @ opA.conj().T \
        + 0.5 * C0
    return P.g(out), (uplo, full, C0)


def _syr2k(P):
    rng = np.random.default_rng(1)
    A = _mat(rng, 9, 5, np.complex128)
    B = _mat(rng, 9, 5, np.complex128)
    out = P.mod.syr2k("U", P.dm(A), P.dm(B), alpha=1.5, nb=4)
    return P.g(out), ("U", 1.5 * (A @ B.T + B @ A.T), None)


def _trr2k(P):
    rng = np.random.default_rng(2)
    A = _mat(rng, 8, 5, np.float64)
    B = _mat(rng, 5, 8, np.float64)
    C = _mat(rng, 8, 5, np.float64)
    D = _mat(rng, 5, 8, np.float64)
    E0 = _mat(rng, 8, 8, np.float64)
    m = P.mod
    Amc = m.redistribute(P.dm(A), m.MC, m.STAR)
    Bmr = m.redistribute(P.dm(B), m.STAR, m.MR)
    Cmc = m.redistribute(P.dm(C), m.MC, m.STAR)
    Dmr = m.redistribute(P.dm(D), m.STAR, m.MR)
    out = m.trr2k("L", 2.0, Amc, Bmr, -1.0, Cmc, Dmr, 0.5, P.dm(E0))
    return P.g(out), ("L", 2.0 * A @ B - C @ D + 0.5 * E0, E0)


def _hemm(P, side, uplo):
    rng = np.random.default_rng(3)
    H = _mat(rng, 8, 8, np.complex128)
    H = H + H.conj().T
    B = _mat(rng, 8, 6, np.complex128) if side == "L" \
        else _mat(rng, 6, 8, np.complex128)
    Pz = H.copy()    # poison the unstored triangle
    mask = np.tril(np.ones((8, 8), bool), -1) if uplo == "U" \
        else np.triu(np.ones((8, 8), bool), 1)
    Pz[mask] = 99.0
    out = P.mod.hemm(side, uplo, P.dm(Pz), P.dm(B), alpha=1.25)
    return P.g(out), 1.25 * (H @ B if side == "L" else B @ H)


def _symm(P):
    rng = np.random.default_rng(4)
    S = _mat(rng, 7, 7, np.complex128)
    S = S + S.T
    B = _mat(rng, 7, 4, np.complex128)
    out = P.mod.symm("L", "U", P.dm(np.triu(S)), P.dm(B))
    return P.g(out), S @ B


def _multishift(P, uplo, orient):
    rng = np.random.default_rng(8)
    m, nrhs = 12, 7
    T = _mat(rng, m, m, np.complex128)
    T = _tri(T, uplo) + 4 * np.eye(m)
    B = _mat(rng, m, nrhs, np.complex128)
    shifts = (rng.normal(size=nrhs) + 1j * rng.normal(size=nrhs)) * 0.5
    out = P.mod.multishift_trsm(uplo, orient, P.dm(T), shifts, P.dm(B),
                                alpha=1.0, nb=4)
    return P.g(out), (T, B, shifts, orient)


def _multishift_zero(P):
    rng = np.random.default_rng(9)
    m, nrhs = 8, 4
    T = np.tril(rng.normal(size=(m, m))) + 3 * np.eye(m)
    B = rng.normal(size=(m, nrhs))
    ms = P.mod.multishift_trsm("L", "N", P.dm(T), np.zeros(nrhs), P.dm(B),
                               nb=4)
    ts = P.mod.trsm("L", "L", "N", P.dm(T), P.dm(B), nb=4)
    return P.g(ms), P.g(ts)


def _quasi_upper(rng, n, nblocks2x2, cplx):
    """tests/lapack/test_variants.py's real (complex-pair 2x2 bumps) and
    complex upper quasi-triangular matrices."""
    if cplx:
        T = np.triu(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))) \
            + 4 * np.eye(n)
    else:
        T = np.triu(rng.normal(size=(n, n))) + 3 * np.eye(n)
    pos = rng.choice(n - 1, nblocks2x2, replace=False)
    pos = [p for p in sorted(pos) if p == 0 or (p - 1 not in pos)]
    for p in pos:
        if cplx:
            a, b = T[p, p], (1.0 + abs(rng.normal())) * (1 + 0.5j)
            T[p + 1, p] = -np.conj(b)
        else:
            a, b = T[p, p], 1.0 + abs(rng.normal())
            T[p + 1, p] = -b
        T[p + 1, p + 1] = a
        T[p, p + 1] = b
    return T


def _quasi(P, side, orient, cplx):
    rng = np.random.default_rng(9 if cplx else 2)
    n, k = 37, 5
    T = _quasi_upper(rng, n, 6, cplx)
    shape = (n, k) if side == "L" else (k, n)
    B = rng.normal(size=shape)
    if cplx:
        B = B + 1j * rng.normal(size=shape)
    X = P.mod.quasi_trsm(side, orient, P.dm(T), P.dm(B), nb=8)
    opT = {"N": T, "T": T.T, "C": np.conj(T).T}[orient]
    ref = np.linalg.solve(opT, B) if side == "L" else B @ np.linalg.inv(opT)
    return P.g(X), ref


def _quasi_triangular(P):
    rng = np.random.default_rng(3)
    n, k = 24, 4
    T = np.triu(rng.normal(size=(n, n))) + 3 * np.eye(n)
    B = rng.normal(size=(n, k))
    X1 = P.mod.quasi_trsm("L", "N", P.dm(T), P.dm(B), nb=8)
    X2 = P.mod.trsm("L", "U", "N", P.dm(T), P.dm(B), nb=8)
    return P.g(X1), P.g(X2)


def _quasi_bump(P):
    rng = np.random.default_rng(8)
    n, k = 16, 3
    T = np.triu(rng.normal(size=(n, n))) + 3 * np.eye(n)
    T[8, 7] = -1.5                     # bump exactly at the nb=8 split
    T[8, 8] = T[7, 7]
    T[7, 8] = 1.5
    B = rng.normal(size=(n, k))
    X = P.mod.quasi_trsm("L", "N", P.dm(T), P.dm(B), nb=8)
    return P.g(X), np.linalg.solve(T, B)


CASES = {
    **{f"her2k_{u}{o}": functools.partial(_her2k, uplo=u, orient=o)
       for u in "LU" for o in "NC"},
    "syr2k": _syr2k,
    "trr2k": _trr2k,
    **{f"hemm_{s}{u}": functools.partial(_hemm, side=s, uplo=u)
       for s in "LR" for u in "LU"},
    "symm": _symm,
    **{f"multishift_{u}{o}": functools.partial(_multishift, uplo=u, orient=o)
       for u, o in (("L", "N"), ("U", "N"), ("U", "C"), ("L", "T"))},
    "multishift_zero": _multishift_zero,
    **{f"quasi_{s}{o}": functools.partial(_quasi, side=s, orient=o,
                                          cplx=False)
       for s, o in (("L", "N"), ("L", "T"), ("R", "N"), ("R", "T"))},
    **{f"quasi_complex_{s}{o}": functools.partial(_quasi, side=s, orient=o,
                                                  cplx=True)
       for s, o in (("L", "C"), ("R", "C"), ("L", "N"), ("R", "T"))},
    "quasi_triangular": _quasi_triangular,
    "quasi_bump": _quasi_bump,
}


@functools.lru_cache(maxsize=None)
def _jax(name):
    return CASES[name](_jax_pkg())[0]


def _oracle(name, got, truth):
    """The JAX tests' own checks of a result."""
    if name.startswith(("her2k", "syr2k", "trr2k")):
        uplo, full, C0 = truth
        np.testing.assert_allclose(_tri(got, uplo), _tri(full, uplo),
                                   rtol=1e-11)
        if C0 is not None:
            other = (lambda x: np.triu(x, 1)) if uplo == "L" \
                else (lambda x: np.tril(x, -1))
            np.testing.assert_array_equal(other(got), other(C0))
    elif name.startswith(("hemm", "symm")):
        np.testing.assert_allclose(got, truth, rtol=1e-11)
    elif name == "multishift_zero":
        np.testing.assert_allclose(got, truth, rtol=1e-12)
    elif name.startswith("multishift"):
        T, B, shifts, orient = truth
        op = {"N": T, "T": T.T, "C": T.conj().T}[orient]
        for j in range(B.shape[1]):
            np.testing.assert_allclose(
                (op - shifts[j] * np.eye(T.shape[0])) @ got[:, j], B[:, j],
                rtol=1e-10, atol=1e-10)
    elif name == "quasi_triangular":
        assert np.allclose(got, truth, atol=1e-10)
    else:
        assert np.allclose(got, truth, atol=1e-9)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("name", list(CASES))
def test_level3_ext_matches_jax(rc, name):
    got, truth = CASES[name](_port_pkg(rc))
    _agree(got, _jax(name))
    _oracle(name, got, truth)
