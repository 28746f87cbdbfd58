"""The port's Hermitian eigensolvers (``herm_eig``, ``skew_herm_eig``,
``hermitian_svd``, ``herm_gen_def_eig``) on 1x1, 2x2 and 2x4 grids
against ``elemental_tpu``: the same numpy inputs from a seed go through
both packages, the JAX side on a 1x1 grid, each JAX reference computed
once per module (its results on other grids agree to rounding; the
compiles per grid dominated this file's time).  Eigenvalues agree to 1e-12 and eigenvectors to 1e-10 up to
each column's sign; each result also meets the residual and
orthogonality bounds of ``tests/lapack/test_spectral.py`` and
``tests/lapack/test_tridiag_eig.py``."""

import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et
from .torch_shared_ref import shared_cache

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]
N, NB = 24, 8


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _sym(n, seed=0, cplx=False):
    rng = np.random.default_rng(seed)
    if cplx:
        G = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
        return (G + G.conj().T) / 2
    G = rng.normal(size=(n, n))
    return (G + G.T) / 2


def _glob(Z):
    return et.to_global(Z).numpy()


def _np(x):
    return np.asarray(el.to_global(x)) if isinstance(x, el.DistMatrix) \
        else np.asarray(x)


@shared_cache
def _jax(fn: str, key: str, *args, **kw):
    """``el.<fn>`` of the inputs named ``key`` on a 1x1 JAX grid, as numpy
    (once per module)."""
    g = jgrid(1, 1)
    mats = [el.from_global(M, el.MC, el.MR, g) for M in _INPUTS[key]()]
    out = getattr(el, fn)(*mats, *args, **kw)
    return tuple(_np(o) for o in out) if isinstance(out, tuple) else _np(out)


def _poisoned(cplx, uplo):
    F = _sym(N, 1 if cplx else 0, cplx)
    P = F.copy()
    # only the selected triangle may be read: poison the other
    P[np.triu_indices(N, 1) if uplo == "L" else np.tril_indices(N, -1)] = \
        np.nan
    return F, P


def _skew():
    G = np.random.default_rng(4).normal(size=(16, 16))
    return G - G.T


def _pencil():
    rng = np.random.default_rng(5)
    G = rng.normal(size=(16, 16))
    return _sym(16, 6), G @ G.T / 16 + 2 * np.eye(16)


_INPUTS = {
    "poison_L": lambda: (_poisoned(False, "L")[1],),
    "poison_c_L": lambda: (_poisoned(True, "L")[1],),
    "poison_c_U": lambda: (_poisoned(True, "U")[1],),
    "sym3": lambda: (_sym(N, 3),),
    "diag24": lambda: (np.diag(np.arange(1.0, 25.0)),),
    "sym200": lambda: (_sym(200, 3),),
    "skew16": lambda: (_skew(),),
    "sym7": lambda: (_sym(N, 7),),
    "pencil": _pencil,
}


def _same_up_to_sign(Z, Zref, tol=1e-10):
    s = np.sign(np.real(np.sum(Z.conj() * Zref, axis=0)))
    s[s == 0] = 1
    np.testing.assert_allclose(Z * s, Zref, rtol=0, atol=tol)


def _close_w(w, jw, tol=1e-12):
    jw = np.asarray(jw)
    np.testing.assert_allclose(w.numpy(), jw, rtol=0,
                               atol=tol * max(np.abs(jw).max(), 1))


def _check_eig(F, w, Zg, tol=1e-12):
    n = F.shape[0]
    wn = np.linalg.eigvalsh(F)
    w = w.numpy()
    assert np.linalg.norm(w - wn) / max(np.linalg.norm(wn), 1) < tol
    assert np.linalg.norm(F @ Zg - Zg @ np.diag(w)) / np.linalg.norm(F) < tol
    assert np.linalg.norm(Zg.conj().T @ Zg - np.eye(n)) < tol * n


@pytest.mark.parametrize("rc,cplx,uplo", [
    ((1, 1), False, "L"), ((2, 2), False, "L"), ((2, 4), False, "L"),
    ((1, 1), True, "L"), ((2, 4), True, "U")],
    ids=["1x1", "2x2", "2x4", "1x1-c128", "2x4-c128-upper"])
def test_herm_eig_matches_jax(rc, cplx, uplo):
    F, P = _poisoned(cplx, uplo)
    tA = et.from_global(P, et.MC, et.MR, tgrid(*rc))
    key = "poison_c_" + uplo if cplx else "poison_L"
    jw, jZ = _jax("herm_eig", key, uplo=uplo, nb=NB)
    w, Z = et.herm_eig(tA, uplo=uplo, nb=NB)
    _close_w(w, jw)
    Zg = _glob(Z)
    _same_up_to_sign(Zg, jZ)
    _check_eig(F, w, Zg)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_herm_eig_subsets_match_jax(rc):
    F = _sym(N, 3)
    tA = et.from_global(F, et.MC, et.MR, tgrid(*rc))
    jw, jZ = _jax("herm_eig", "sym3", subset=("index", 2, 6), nb=NB)
    w, Z = et.herm_eig(tA, subset=("index", 2, 6), nb=NB)
    _close_w(w, jw)
    Zg = _glob(Z)
    assert Zg.shape == (N, 5)
    _same_up_to_sign(Zg, jZ)
    assert np.linalg.norm(F @ Zg - Zg @ np.diag(w.numpy())) < 1e-11
    # range='V' selects the half-open (lo, hi]
    D = np.diag(np.arange(1.0, 25.0))
    tD = et.from_global(D, et.MC, et.MR, tgrid(*rc))
    w = et.herm_eig(tD, vectors=False, subset=("value", 5.0, 9.0))
    jw = _jax("herm_eig", "diag24", vectors=False, subset=("value", 5.0, 9.0))
    np.testing.assert_array_equal(w.numpy(), jw)
    np.testing.assert_allclose(w.numpy(), [6.0, 7.0, 8.0, 9.0])


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_herm_eig_divide_and_conquer_matches_jax(rc):
    """dc_min = 0 forces the D&C tridiagonal stage; n = 200 with repl_max =
    96 runs one batched level and one distributed merge."""
    n = 200
    F = _sym(n, 3)
    tA = et.from_global(F, et.MC, et.MR, tgrid(*rc))
    jw, jZ = _jax("herm_eig", "sym200", dc_min=0, repl_max=96)
    w, Z = et.herm_eig(tA, dc_min=0, repl_max=96)
    _close_w(w, jw)
    Zg = _glob(Z)
    _same_up_to_sign(Zg, jZ)
    wref = np.linalg.eigvalsh(F)
    assert np.abs(w.numpy() - wref).max() < 1e-9
    assert np.linalg.norm(F @ Zg - Zg * w.numpy()[None, :]) \
        / np.linalg.norm(F) < 1e-10
    assert np.linalg.norm(Zg.T @ Zg - np.eye(n)) < 1e-10 * n
    # values only, and a subset through the D&C branch
    wv = et.herm_eig(tA, vectors=False, dc_min=0, repl_max=64)
    _close_w(wv, _jax("herm_eig", "sym200", vectors=False, dc_min=0,
                      repl_max=64))
    ws, Zs = et.herm_eig(tA, subset=("index", 10, 29), dc_min=0, repl_max=64)
    np.testing.assert_allclose(ws.numpy(), wref[10:30], rtol=0, atol=1e-9)
    Zsg = _glob(Zs)
    assert Zsg.shape == (n, 20)
    assert np.linalg.norm(F @ Zsg - Zsg * ws.numpy()[None, :]) \
        / np.linalg.norm(F) < 1e-10


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_skew_herm_eig_matches_jax(rc):
    F = _skew()
    imag_all = np.sort(np.linalg.eigvals(F).imag)
    tA = et.from_global(F, et.MC, et.MR, tgrid(*rc))
    w, Z = et.skew_herm_eig(tA, subset=("index", 0, 3))
    jw, jZ = _jax("skew_herm_eig", "skew16", subset=("index", 0, 3))
    _close_w(w, jw)
    np.testing.assert_allclose(w.numpy(), imag_all[:4], atol=1e-11)
    Zg = _glob(Z)
    _same_up_to_sign(Zg, jZ)
    r = F.astype(complex) @ Zg - Zg @ np.diag(1j * w.numpy())
    assert np.linalg.norm(r) / max(np.linalg.norm(F), 1) < 1e-11
    # window ends between eigenvalues: an end equal to an eigenvalue that
    # numpy computed is a tie the two packages' roundings may break apart
    lo = (imag_all[5] + imag_all[6]) / 2
    hi = (imag_all[9] + imag_all[10]) / 2
    wv = et.skew_herm_eig(tA, vectors=False, subset=("value", lo, hi))
    _close_w(wv, _jax("skew_herm_eig", "skew16", vectors=False,
                      subset=("value", lo, hi)))
    np.testing.assert_allclose(wv.numpy(), imag_all[6:10], atol=1e-11)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_hermitian_svd_matches_jax(rc):
    F = _sym(N, 7)
    tA = et.from_global(F, et.MC, et.MR, tgrid(*rc))
    U, s, V = et.hermitian_svd(tA, nb=NB)
    jU, js, jV = _jax("hermitian_svd", "sym7", nb=NB)
    _close_w(s, js)
    np.testing.assert_allclose(s.numpy(), np.linalg.svd(F, compute_uv=False),
                               atol=1e-12)
    Ug, Vg = _glob(U), _glob(V)
    _same_up_to_sign(Vg, jV)
    assert np.linalg.norm(Ug @ np.diag(s.numpy()) @ Vg.T - F) \
        / np.linalg.norm(F) < 1e-12
    sv = et.hermitian_svd(tA, vectors=False, nb=NB)
    _close_w(sv, s)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_herm_gen_def_eig_matches_jax(rc):
    A, B = _pencil()
    g = tgrid(*rc)
    tA = et.from_global(A, et.MC, et.MR, g)
    tB = et.from_global(B, et.MC, et.MR, g)
    w, X = et.herm_gen_def_eig(tA, tB, nb=4)
    jw, jX = _jax("herm_gen_def_eig", "pencil", nb=4)
    _close_w(w, jw)
    Xg = _glob(X)
    _same_up_to_sign(Xg, jX)
    r = A @ Xg - B @ Xg @ np.diag(w.numpy())
    assert np.linalg.norm(r) / np.linalg.norm(A) < 1e-11
    assert np.linalg.norm(Xg.T @ B @ Xg - np.eye(16)) < 1e-10
    wv = et.herm_gen_def_eig(tA, tB, vectors=False, nb=4)
    _close_w(wv, w)


def test_small_orders_and_refusals():
    g = tgrid(1, 1)
    for n in (1, 2):
        F = _sym(n, 8)
        w, Z = et.herm_eig(et.from_global(F, et.MC, et.MR, g))
        _check_eig(F, w, _glob(Z))
    F = _sym(8, 9)
    A = et.from_global(F, et.MC, et.MR, g)
    # approach='qdwh' is ported (lapack/funcs.py) and no longer refused
    w, Z = et.herm_eig(A, approach="qdwh")
    _check_eig(F, w, _glob(Z))
    with pytest.raises(ValueError, match="unknown approach"):
        et.herm_eig(A, approach="pmrrr")
    with pytest.raises(ValueError):
        et.herm_eig(et.from_global(np.ones((4, 3)), et.MC, et.MR, g))
