"""The port's Schur layer (``lapack/schur.py``: ``schur`` by sign-function
spectral divide and conquer, ``triang_eig``, ``eig``, ``pseudospectra``)
against ``elemental_tpu``: the inputs of ``tests/lapack/test_schur.py``
(made from the same seeds with numpy) go through both packages, the JAX
package once per input on a 1x1 grid and the port on 1x1, 2x2 and 2x4
grids.  Both draw the SDC's splitting lines and range finder from the same
seeded generator, so they split alike: the eigenvalues on T's diagonal
agree to 1e-10 in order, and T and Q to 1e-10 after Q's columns are
aligned in phase (a Schur form is unique only up to a unitary diagonal).
Every result meets the JAX tests' own residual bounds.

The JAX references run on a 1x1 JAX grid: on its 8 virtual CPU devices a
JAX call that dispatches many small sharded computations in turn can
starve XLA's in-process all-reduce rendezvous when the host is loaded
(several test workers), which aborts the process after 40 s
(``rendezvous.cc``: "Termination timeout ... exceeded"); one device has
no rendezvous.
"""
import functools
import importlib

import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et

jschur = importlib.import_module("elemental_tpu.lapack.schur")
tschur = importlib.import_module("elemental_tpu_torch.lapack.schur")

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]


def _jg(F):
    return el.from_global(F, el.MC, el.MR,
                          grid=el.Grid(jax.devices()[:1], height=1))


def _tg(F, rc):
    return et.from_global(F, et.MC, et.MR, grid=et.Grid(*rc, device="cpu"))


def _t(A):
    return et.to_global(A).numpy()


def _agree(got, want, tol=1e-10):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1))


#: name -> (input, base): the replicated base case, and the SDC with
#: several levels on a real and on a complex input
def _schur_input(name):
    if name == "replicated":
        return np.random.default_rng(2).normal(size=(16, 16)), None
    if name == "sdc_real":
        # test_eig_general's input: eig's JAX reference reuses its programs
        return np.random.default_rng(4).normal(size=(40, 40)), 12
    if name == "sdc_complex":
        rng = np.random.default_rng(1)
        return rng.normal(size=(24, 24)) + 1j * rng.normal(size=(24, 24)), 8
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _jax_schur(name):
    F, base = _schur_input(name)
    T, Q = jschur.schur(_jg(F), base=base)
    return np.asarray(el.to_global(T)), np.asarray(el.to_global(Q))


def _check_schur(F, Tg, Qg, tol=1e-12):
    """tests/lapack/test_schur.py::_check_schur."""
    n = F.shape[0]
    assert np.linalg.norm(np.tril(Tg, -1)) == 0
    assert np.linalg.norm(Qg.conj().T @ Qg - np.eye(n)) < tol * n
    assert np.linalg.norm(F - Qg @ Tg @ Qg.conj().T) / np.linalg.norm(F) < tol
    ev = np.linalg.eigvals(F)
    d = np.abs(ev[:, None] - np.diag(Tg)[None, :])
    assert d.min(axis=1).max() < 1e-10 * max(np.abs(ev).max(), 1)


def _phases(Q, Qref):
    """The unitary diagonal D with Q ~= Qref D (column by column)."""
    c = np.sum(Qref.conj() * Q, axis=0)
    return c / np.abs(c)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("name", ["replicated", "sdc_real", "sdc_complex"])
def test_schur_matches_jax(rc, name):
    F, base = _schur_input(name)
    T, Q = tschur.schur(_tg(F, rc), base=base)
    Tg, Qg = _t(T), _t(Q)
    jT, jQ = _jax_schur(name)
    _agree(np.diag(Tg), np.diag(jT))
    D = _phases(Qg, jQ)
    _agree(Qg, jQ * D[None, :])
    _agree(Tg, D.conj()[:, None] * jT * D[None, :])
    _check_schur(F, Tg, Qg)


def _triang_input(name):
    if name == "random":
        import scipy.linalg
        F = np.random.default_rng(3).normal(size=(40, 40))
        return scipy.linalg.schur(F, output="complex")[0]
    T = np.triu(np.ones((8, 8))) * 0.3
    np.fill_diagonal(T, [1.0, 1.0, 2.0, 2.0, 2.0, 3.0, 4.0, 5.0])
    T[0, 1] = 1.0                                  # explicit Jordan coupling
    return T.astype(complex)


@functools.lru_cache(maxsize=None)
def _jax_triang(name):
    w, V = jschur.triang_eig(_jg(_triang_input(name)), nb=8)
    return np.asarray(w), np.asarray(el.to_global(V))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("name", ["random", "defective"])
def test_triang_eig_matches_jax(rc, name):
    Tn = _triang_input(name)
    w, V = tschur.triang_eig(_tg(Tn, rc), nb=8)
    wg, Vg = w.numpy(), _t(V)
    jw, jV = _jax_triang(name)
    _agree(wg, jw, 1e-12)
    _agree(Vg, jV)
    R = Tn @ Vg - Vg @ np.diag(wg)
    if name == "random":
        # tests/lapack/test_schur.py::test_triang_eig
        assert np.linalg.norm(R, axis=0).max() < 1e-12 * np.linalg.norm(Tn)
        assert np.allclose(np.linalg.norm(Vg, axis=0), 1.0, atol=1e-12)
    else:
        # ::test_triang_eig_defective: finite unit vectors, exact ones for
        # the distinct eigenvalues
        assert np.all(np.isfinite(Vg))
        assert np.allclose(np.linalg.norm(Vg, axis=0), 1.0, atol=1e-10)
        assert np.linalg.norm(R, axis=0)[[5, 6, 7]].max() < 1e-10


@functools.lru_cache(maxsize=None)
def _jax_eig():
    F = np.random.default_rng(4).normal(size=(40, 40))
    w, V = jschur.eig(_jg(F), base=12)
    return np.asarray(w), np.asarray(el.to_global(V))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_eig_matches_jax(rc):
    F = np.random.default_rng(4).normal(size=(40, 40))
    w, V = tschur.eig(_tg(F, rc), base=12)
    wg, Vg = w.numpy(), _t(V)
    jw, jV = _jax_eig()
    _agree(wg, jw)
    _agree(Vg, jV * _phases(Vg, jV)[None, :])
    # tests/lapack/test_schur.py::test_eig_general
    r = F.astype(complex) @ Vg - Vg @ np.diag(wg)
    assert np.linalg.norm(r) / np.linalg.norm(F) < 1e-11


@functools.lru_cache(maxsize=None)
def _jax_pspec():
    F = np.random.default_rng(5).normal(size=(32, 32))
    Z, sm = jschur.pseudospectra(_jg(F), (-3, 3), (-3, 3), nx=4, ny=4,
                                 iters=14, base=64)
    return Z, sm


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_pseudospectra_matches_jax(rc):
    F = np.random.default_rng(5).normal(size=(32, 32))
    Z, sm = tschur.pseudospectra(_tg(F, rc), (-3, 3), (-3, 3), nx=4, ny=4,
                                 iters=14, base=64)
    jZ, jsm = _jax_pspec()
    np.testing.assert_array_equal(Z, jZ)
    _agree(sm, jsm, 1e-12)
    # tests/lapack/test_schur.py::test_pseudospectra_map
    direct = np.array([[np.linalg.svd(F - z * np.eye(32),
                                      compute_uv=False)[-1]
                        for z in row] for row in Z])
    assert np.max(np.abs(sm - direct) / np.maximum(direct, 1e-12)) < 1e-3


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_pseudospectra_deflation_matches_jax(rc):
    """tests/lapack/test_schur.py's deflation cases: the checks at which a
    batch freezes (quiet_checks = 1 and 3), and a deflated run against an
    undeflated one, each equal to the JAX package's."""
    F = np.random.default_rng(12).normal(size=(16, 16))

    def checks(pkg, dm, K):
        out = []
        pkg.pseudospectra(dm(F), (-2, 2), (-2, 2), nx=3, ny=2, iters=30,
                          tol=1e30, check_every=2, quiet_checks=K,
                          snapshot=lambda it, Z, S: out.append(it))
        return out

    assert checks(tschur, lambda X: _tg(X, rc), 1) == [2, 4]
    assert checks(tschur, lambda X: _tg(X, rc), 3) == [2, 4, 6, 8]
    F2 = np.random.default_rng(11).normal(size=(24, 24))
    snaps = []
    _, s1 = tschur.pseudospectra(_tg(F2, rc), (-3, 3), (-3, 3), nx=5, ny=4,
                                 iters=24, tol=1e-5, deflate=True,
                                 snapshot=lambda it, Z, S: snaps.append(it))
    _, s2 = tschur.pseudospectra(_tg(F2, rc), (-3, 3), (-3, 3), nx=5, ny=4,
                                 iters=24, tol=1e-5, deflate=False)
    assert snaps == _jax_deflation_snaps()
    ok = (s1 > 0) & (s2 > 0)
    assert ok.mean() > 0.9
    rel = np.abs(s1[ok] - s2[ok]) / np.maximum(s2[ok], 1e-300)
    assert np.median(rel) < 5e-2


@functools.lru_cache(maxsize=None)
def _jax_deflation_snaps():
    F2 = np.random.default_rng(11).normal(size=(24, 24))
    snaps = []
    jschur.pseudospectra(_jg(F2), (-3, 3), (-3, 3), nx=5, ny=4, iters=24,
                         tol=1e-5, deflate=True,
                         snapshot=lambda it, Z, S: snaps.append(it))
    return snaps
