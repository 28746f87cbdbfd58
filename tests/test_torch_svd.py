"""The port's SVD (every ``svd`` route, ``vectors=False``) and
``herm_eig(approach='qdwh')`` against ``elemental_tpu``: the same numpy
inputs from a seed go through both packages, the JAX package once per
input on a 1x1 grid and the port on 1x1, 2x2 and 2x4 grids.  Singular
values and eigenvalues agree to 1e-12, U, V and Z to 1e-10 after each
column's sign is aligned (the inputs' values are separated), and every
result meets ``tests/lapack/test_spectral.py``'s oracles; the Golub-Kahan
route is held to the JAX tests' bounds (it squares the condition number).
"""

import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.lapack.funcs import _qdwh_eig as j_qdwh_eig
from elemental_tpu_torch.lapack.funcs import _qdwh_eig as t_qdwh_eig
from .torch_shared_ref import shared_cache

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]

#: route name -> (shape, seed, svd keyword arguments, nb)
ROUTES = {
    "auto_tall": ((48, 16), 10, {}, 8),
    "chan": ((40, 16), 10, {"approach": "chan"}, 8),
    "chan_polar": ((200, 136), 16, {"approach": "chan"}, 64),
    "polar": ((24, 24), 8, {}, 8),
    "polar_tall": ((30, 20), 17, {"approach": "polar"}, 8),
    "golub": ((30, 20), 18, {"approach": "golub"}, 8),
    "local": ((20, 12), 19, {"approach": "local"}, 8),
    "wide": ((16, 40), 11, {}, 8),
    "eig_qdwh": ((24, 24), 20, {"eig_approach": "qdwh"}, 8),
}


def _jg(F):
    return el.from_global(F, el.MC, el.MR, grid=el.Grid(jax.devices()[:1],
                                                        height=1))


def _tg(F, rc):
    return et.from_global(F, et.MC, et.MR, grid=et.Grid(*rc, device="cpu"))


def _t(A):
    return et.to_global(A).numpy()


def _input(route):
    shape, seed, _, _ = ROUTES[route]
    return np.random.default_rng(seed).normal(size=shape)


@shared_cache
def _jax_svd(route, vectors=True):
    _, _, kw, nb = ROUTES[route]
    out = el.svd(_jg(_input(route)), vectors=vectors, nb=nb, **kw)
    if not vectors:
        return np.asarray(out)
    U, s, V = out
    return (np.asarray(el.to_global(U)), np.asarray(s),
            np.asarray(el.to_global(V)))


def _align(Z, Zref):
    """Z with each column's sign flipped to agree with Zref's."""
    s = np.sign(np.real(np.sum(Z.conj() * Zref, axis=0)))
    s[s == 0] = 1
    return Z * s


def _check_svd(F, s, Ug, Vg, tol=1e-12):
    """tests/lapack/test_spectral.py::_check_svd."""
    sn = np.linalg.svd(F, compute_uv=False)
    k = len(s)
    assert np.allclose(s, sn[:k], atol=tol * max(sn[0], 1))
    rec = Ug @ np.diag(s) @ Vg.conj().T
    assert np.linalg.norm(rec - F) / np.linalg.norm(F) < tol
    assert np.linalg.norm(Ug.conj().T @ Ug - np.eye(k)) < tol * k
    assert np.linalg.norm(Vg.conj().T @ Vg - np.eye(k)) < tol * k


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_svd_routes_match_jax(rc, route):
    F = _input(route)
    _, _, kw, nb = ROUTES[route]
    U, s, V = et.svd(_tg(F, rc), nb=nb, **kw)
    Ug, s, Vg = _t(U), s.numpy(), _t(V)
    jU, js, jV = _jax_svd(route)
    np.testing.assert_allclose(s, js, rtol=0, atol=1e-12 * js.max())
    np.testing.assert_allclose(_align(Ug, jU), jU, rtol=0, atol=1e-10)
    np.testing.assert_allclose(_align(Vg, jV), jV, rtol=0, atol=1e-10)
    _check_svd(F, s, Ug, Vg)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("route", ["chan", "polar", "golub", "local", "wide"])
def test_svd_values_only_match_jax(rc, route):
    F = _input(route)
    _, _, kw, nb = ROUTES[route]
    s = et.svd(_tg(F, rc), vectors=False, nb=nb, **kw).numpy()
    js = _jax_svd(route, vectors=False)
    np.testing.assert_allclose(s, js, rtol=0, atol=1e-12 * js.max())
    np.testing.assert_allclose(s, np.linalg.svd(F, compute_uv=False),
                               atol=1e-12)


@pytest.mark.parametrize("rc", [(1, 1), (2, 4)], ids=["1x1", "2x4"])
def test_svd_square_complex(rc):
    """tests/lapack/test_spectral.py::test_svd_square_complex."""
    rng = np.random.default_rng(9)
    F = rng.normal(size=(16, 16)) + 1j * rng.normal(size=(16, 16))
    U, s, V = et.svd(_tg(F, rc))
    _check_svd(F, s.numpy(), _t(U), _t(V))


def _sym(n, seed):
    G = np.random.default_rng(seed).normal(size=(n, n))
    return (G + G.T) / 2


def _check_eig(F, w, Zg, tol=1e-12):
    """tests/lapack/test_spectral.py::_check_eig."""
    n = F.shape[0]
    wn = np.linalg.eigvalsh(F)
    assert np.linalg.norm(w - wn) / max(np.linalg.norm(wn), 1) < tol
    assert np.linalg.norm(F @ Zg - Zg @ np.diag(w)) / np.linalg.norm(F) < tol
    assert np.linalg.norm(Zg.conj().T @ Zg - np.eye(n)) < tol * n


@shared_cache
def _jax_qdwh(n, seed, base):
    w, Z = j_qdwh_eig(_jg(_sym(n, seed)), "L", True, base=base)
    return np.asarray(w), np.asarray(el.to_global(Z))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_qdwh_eig_recursive_matches_jax(rc):
    """A small base forces two or more levels of the spectral divide and
    conquer; both packages draw the same range-finder G."""
    F = _sym(40, 13)
    A = _tg(F, rc)
    w, Z = t_qdwh_eig(A, "L", True, base=12)
    jw, jZ = _jax_qdwh(40, 13, 12)
    np.testing.assert_allclose(w.numpy(), jw, rtol=0,
                               atol=1e-12 * np.abs(jw).max())
    Zg = _t(Z)
    np.testing.assert_allclose(_align(Zg, jZ), jZ, rtol=0, atol=1e-10)
    _check_eig(F, w.numpy(), Zg)
    # subsets ride the same path
    ws = t_qdwh_eig(A, "L", False, subset=("index", 3, 9), base=12)
    np.testing.assert_allclose(ws.numpy(), np.linalg.eigvalsh(F)[3:10],
                               atol=1e-12)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_herm_eig_qdwh_public_api(rc):
    F = _sym(24, 14)
    jw, jZ = el.herm_eig(_jg(F), approach="qdwh")
    w, Z = et.herm_eig(_tg(F, rc), approach="qdwh")
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-12 * np.abs(jw).max())
    Zg = _t(Z)
    jZ = np.asarray(el.to_global(jZ))
    np.testing.assert_allclose(_align(Zg, jZ), jZ, rtol=0, atol=1e-10)
    _check_eig(F, w.numpy(), Zg)
    # the upper triangle read, and values only
    P = np.triu(F) + np.tril(np.full_like(F, np.nan), -1)
    wu = et.herm_eig(_tg(P, rc), uplo="U", vectors=False, approach="qdwh")
    np.testing.assert_allclose(wu.numpy(), w.numpy(), atol=1e-12)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_qdwh_eig_clustered(rc):
    """tests/lapack/test_spectral.py::test_qdwh_eig_clustered: blocks that
    are near multiples of the identity deflate, they do not loop."""
    rng = np.random.default_rng(15)
    Q, _ = np.linalg.qr(rng.normal(size=(32, 32)))
    d = np.concatenate([np.full(16, 2.0), np.full(16, 5.0)])
    F = (Q * d) @ Q.T
    F = (F + F.T) / 2
    w, Z = t_qdwh_eig(_tg(F, rc), "L", True, base=8)
    assert np.allclose(np.sort(w.numpy()), np.sort(d), atol=1e-10)
    Zg = _t(Z)
    assert np.linalg.norm(F @ Zg - Zg @ np.diag(w.numpy())) \
        / np.linalg.norm(F) < 1e-10


def test_svd_refuses_unknown_route():
    with pytest.raises(ValueError, match="unknown svd approach"):
        et.svd(_tg(np.ones((6, 4)), (1, 1)), approach="jacobi")
