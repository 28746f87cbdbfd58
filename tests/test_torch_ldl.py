"""The port's Bunch-Kaufman LDL (``lapack/ldl.py``: ``ldl``,
``ldl_solve_after``, ``symmetric_solve``, ``hermitian_solve``,
``inertia``) against ``elemental_tpu``: the same numpy inputs from a seed
(``tests/lapack/test_ldl.py``'s, plus a 64 x 64 KKT saddle-point matrix,
the shape of ``chip_smoke.py`` phase 3g) go through both packages, the JAX
package once per input on a 1x1 grid and the port on 1x1, 2x2 and 2x4
grids.  The permutation is equal exactly, d, e and L (the strictly-lower
triangle of the packed factor) agree to 1e-12 of the largest entry, and
the port's factor meets the JAX tests' reconstruction bounds.

The JAX references run on a 1x1 JAX grid: on its 8 virtual CPU devices a
JAX call that dispatches many small sharded computations in turn can
starve XLA's in-process all-reduce rendezvous when the host is loaded
(several test workers), which aborts the process after 40 s
(``rendezvous.cc``: "Termination timeout ... exceeded"); one device has
no rendezvous.
"""
import importlib

import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et
from .torch_shared_ref import shared_cache

jldl = importlib.import_module("elemental_tpu.lapack.ldl")
tldl = importlib.import_module("elemental_tpu_torch.lapack.ldl")

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]


def _sym(n, seed=0, cplx=False):
    rng = np.random.default_rng(seed)
    if cplx:
        G = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
        return (G + G.conj().T) / 2
    G = rng.normal(size=(n, n))
    return (G + G.T) / 2


def _kkt(n, p, seed):
    """[[H, J^T], [J, 0]] with H = G G^T / n + I: chip_smoke.py phase 3g's
    saddle-point matrix at a small size."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, n))
    J = rng.normal(size=(p, n))
    K = np.zeros((n + p, n + p))
    K[:n, :n] = G @ G.T / n + np.eye(n)
    K[:n, n:] = J.T
    K[n:, :n] = J
    return K


#: name -> (input, conjugate, nb, uplo, reconstruction bound); the inputs
#: and bounds of tests/lapack/test_ldl.py, and the KKT case
def _case(name):
    if name == "symmetric":
        return _sym(24, 0), False, 8, "L", 1e-13
    if name == "full_panel":
        return _sym(24, 1), False, 32, "L", 1e-13
    if name == "hermitian":
        return _sym(16, 2, cplx=True), True, 8, "L", 1e-13
    if name == "complex_symmetric":
        rng = np.random.default_rng(3)
        G = rng.normal(size=(16, 16)) + 1j * rng.normal(size=(16, 16))
        return (G + G.T) / 2, False, 8, "L", 1e-13
    if name == "pivot_stress":
        F = _sym(24, 4)
        np.fill_diagonal(F, 1e-12)
        return F, False, 8, "L", 1e-12
    if name == "saddle":
        n = 8
        F = np.zeros((2 * n, 2 * n))
        F[:n, n:] = np.eye(n)
        F[n:, :n] = np.eye(n)
        return F, False, 16, "L", 1e-13
    if name == "upper":
        F = _sym(16, 8)
        P = F.copy()
        P[np.tril_indices(16, -1)] = np.nan     # only the upper is read
        return P, False, 8, "U", 1e-13
    if name == "kkt":
        return _kkt(48, 16, 9), False, 16, "L", 1e-13
    raise KeyError(name)


CASES = ["symmetric", "full_panel", "hermitian", "complex_symmetric",
         "pivot_stress", "saddle", "upper", "kkt"]


def _truth(name):
    F, *_ = _case(name)
    if name == "upper":
        return _sym(16, 8)
    return F


def _jg(F):
    return el.from_global(F, el.MC, el.MR,
                          grid=el.Grid(jax.devices()[:1], height=1))


def _tg(F, rc):
    return et.from_global(F, et.MC, et.MR, grid=et.Grid(*rc, device="cpu"))


def _t(A):
    return et.to_global(A).numpy()


@shared_cache
def _jax_ldl(name):
    F, conj, nb, uplo, _ = _case(name)
    Lp, d, e, perm = jldl.ldl(_jg(F), uplo=uplo, conjugate=conj, nb=nb)
    return (np.asarray(el.to_global(Lp)), np.asarray(d), np.asarray(e),
            np.asarray(perm))


def _reconstruct(F, Lg, d, e, perm, conj):
    """tests/lapack/test_ldl.py's ||P A P^T - L D L^H|| / ||A||."""
    n = F.shape[0]
    L = np.tril(Lg, -1) + np.eye(n)
    D = np.diag(d.astype(complex) if np.iscomplexobj(F) else d)
    for j in range(n - 1):
        if e[j] != 0:
            D[j + 1, j] = e[j]
            D[j, j + 1] = np.conj(e[j]) if conj else e[j]
    PAP = F[np.ix_(perm, perm)]
    rec = L @ D @ (L.conj().T if conj else L.T)
    return np.linalg.norm(rec - PAP) / np.linalg.norm(F)


def _agree(got, want, tol=1e-12):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("name", CASES)
def test_ldl_matches_jax(rc, name):
    F, conj, nb, uplo, bound = _case(name)
    Lp, d, e, perm = tldl.ldl(_tg(F, rc), uplo=uplo, conjugate=conj, nb=nb)
    Lg, dn, en, pn = _t(Lp), d.numpy(), e.numpy(), perm.numpy()
    jL, jd, je, jp = _jax_ldl(name)
    np.testing.assert_array_equal(pn, jp)
    _agree(np.tril(Lg, -1), np.tril(jL, -1))
    _agree(dn, jd)
    _agree(en, je)
    assert _reconstruct(_truth(name), Lg, dn, en, pn, conj) < bound
    if conj:
        assert dn.dtype.kind == "f"                 # real D diagonal
    if name == "pivot_stress":
        assert np.any(en != 0)                      # 2x2 blocks used


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_hermitian_ldl_stays_accurate_past_the_jax_tests_size(rc):
    """LDL^H at n = 64, nb = 16 (complex128, 20 2x2 pivots): the port makes
    each corrected column's diagonal entry real, as LAPACK's zlahef does,
    and meets the JAX tests' 1e-13 reconstruction bound here too.  (The
    JAX package keeps the rounding of that imaginary part, which enters
    the 2x2 inverses and grows from block to block: 2.2e-10 on this input
    on its 1x1 grid.)"""
    F = _sym(64, 10, cplx=True)
    Lp, d, e, perm = tldl.ldl(_tg(F, rc), conjugate=True, nb=16)
    dn, en = d.numpy(), e.numpy()
    assert np.count_nonzero(en) >= 10
    assert _reconstruct(F, _t(Lp), dn, en, perm.numpy(), True) < 1e-13


@shared_cache
def _jax_solve(kind):
    F, B = _solve_inputs(kind)
    fn = jldl.symmetric_solve if kind == "symmetric" else jldl.hermitian_solve
    return np.asarray(el.to_global(fn(_jg(F), _jg(B), nb=8)))


def _solve_inputs(kind):
    """tests/lapack/test_ldl.py::test_symmetric_solve / test_hermitian_solve."""
    if kind == "symmetric":
        rng = np.random.default_rng(5)
        return _sym(24, 5), rng.normal(size=(24, 3))
    rng = np.random.default_rng(6)
    return (_sym(16, 6, cplx=True),
            rng.normal(size=(16, 3)) + 1j * rng.normal(size=(16, 3)))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("kind", ["symmetric", "hermitian"])
def test_solve_matches_jax(rc, kind):
    F, B = _solve_inputs(kind)
    fn = tldl.symmetric_solve if kind == "symmetric" else tldl.hermitian_solve
    X = _t(fn(_tg(F, rc), _tg(B, rc), nb=8))
    _agree(X, _jax_solve(kind))
    assert np.linalg.norm(F @ X - B) / np.linalg.norm(B) < 1e-12


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_inertia_matches_jax(rc):
    """tests/lapack/test_ldl.py::test_inertia: Sylvester's law against the
    eigenvalue signs, and the JAX package's counts from its own factor."""
    F = _sym(24, 7)
    _, d, e, _ = tldl.ldl(_tg(F, rc), conjugate=False, nb=8)
    got = tldl.inertia(d, e)
    assert got == jldl.inertia(*_jax_ldl_de(24, 7))
    wn = np.linalg.eigvalsh(F)
    assert got == (int((wn > 0).sum()), int((wn < 0).sum()), 0)
    K = _kkt(48, 16, 9)
    _, d, e, _ = tldl.ldl(_tg(K, rc), conjugate=False, nb=16)
    assert tldl.inertia(d, e) == (48, 16, 0)


@shared_cache
def _jax_ldl_de(n, seed):
    _, d, e, _ = jldl.ldl(_jg(_sym(n, seed)), conjugate=False, nb=8)
    return np.asarray(d), np.asarray(e)


#: the public names this slice ports, on the package (and ``lapack``'s
#: ``matrix_inertia``)
NEW_NAMES = ["trr2k", "her2k", "syr2k", "hemm", "symm", "multishift_trsm",
             "quasi_trsm", "ldl", "ldl_solve_after", "symmetric_solve",
             "hermitian_solve", "inertia", "ridge", "tikhonov", "lse", "glm",
             "determinant", "safe_determinant", "hpd_determinant",
             "two_norm_estimate", "condition", "nuclear_norm",
             "schatten_norm", "two_norm", "qr_col_piv", "lu_full_pivot",
             "schur", "triang_eig", "eig", "pseudospectra", "sylvester",
             "lyapunov", "riccati", "lapack.matrix_inertia"]


@pytest.mark.parametrize("name", NEW_NAMES)
def test_public_signatures_match_the_jax_package(name):
    import inspect

    def get(pkg):
        obj = pkg
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj
    assert str(inspect.signature(get(et))) == str(inspect.signature(get(el)))
