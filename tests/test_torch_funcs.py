"""The port's matrix functions (``lapack/funcs.py``: QDWH ``polar``,
``sign``, the inverses, ``pseudoinverse``, the square roots) against
``elemental_tpu``: the same numpy inputs from a seed go through both
packages, the JAX package on a 1x1 grid (each result computed once) and
the port on 1x1, 2x2 and 2x4 grids.  Results agree to 1e-10 and meet the
JAX tests' own residual bounds; the QDWH schedule is the JAX package's,
number for number.

The JAX references run on a 1x1 JAX grid: on its 8 virtual CPU devices
the many small sharded computations of a call such as ``pseudoinverse``
can starve XLA's in-process all-reduce rendezvous when the host is loaded
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
from elemental_tpu.lapack import funcs as jfuncs
from elemental_tpu_torch.lapack import funcs as tfuncs

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]


def _jg(F):
    return el.from_global(F, el.MC, el.MR,
                          grid=el.Grid(jax.devices()[:1], height=1))


def _tg(F, rc):
    return et.from_global(F, et.MC, et.MR,
                          grid=et.Grid(*rc, device="cpu"))


def _t(A):
    return et.to_global(A).numpy()


def _inputs(name):
    """The JAX tests' inputs (tests/lapack/test_funcs.py), by name."""
    if name == "square":
        return np.random.default_rng(0).normal(size=(24, 24))
    if name == "tall":
        return np.random.default_rng(1).normal(size=(32, 16))
    if name == "wide":
        return np.random.default_rng(1).normal(size=(16, 32))
    if name == "complex":
        rng = np.random.default_rng(1)
        return rng.normal(size=(16, 16)) + 1j * rng.normal(size=(16, 16))
    if name == "ill":
        rng = np.random.default_rng(2)
        Q1, _ = np.linalg.qr(rng.normal(size=(24, 24)))
        Q2, _ = np.linalg.qr(rng.normal(size=(24, 24)))
        return (Q1 * np.logspace(0, -10, 24)) @ Q2.T      # cond 1e10
    if name == "sign":
        rng = np.random.default_rng(3)
        V = rng.normal(size=(16, 16)) + 3 * np.eye(16)
        d = np.concatenate([rng.uniform(0.5, 2, 8), -rng.uniform(0.5, 2, 8)])
        return V @ np.diag(d) @ np.linalg.inv(V), \
            V @ np.diag(np.sign(d)) @ np.linalg.inv(V)
    if name == "general":
        return np.random.default_rng(4).normal(size=(24, 24)) + 6 * np.eye(24)
    if name == "lower":
        return np.tril(np.random.default_rng(5).normal(size=(24, 24))) \
            + 4 * np.eye(24)
    if name == "upper":
        return np.triu(np.random.default_rng(5).normal(size=(24, 24))) \
            + 4 * np.eye(24)
    if name == "hpd":
        G = np.random.default_rng(6).normal(size=(24, 24))
        return G @ G.T / 24 + 2 * np.eye(24)
    if name == "pinv_tall":
        return np.random.default_rng(7).normal(size=(32, 16))
    if name == "pinv_rank":
        rng = np.random.default_rng(7)
        rng.normal(size=(32, 16))
        return rng.normal(size=(24, 8)) @ rng.normal(size=(8, 24))
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _jax(fn, name):
    """The JAX package's result of ``fn`` on input ``name`` (global
    arrays), computed once."""
    F = _inputs(name)
    F = F[0] if name == "sign" else F
    if fn == "polar":
        U, H = el.polar(_jg(F))
        return np.asarray(el.to_global(U)), np.asarray(el.to_global(H))
    if fn in ("triangular_inverse",):
        out = el.triangular_inverse("L" if name == "lower" else "U", _jg(F))
    else:
        out = getattr(el, fn)(_jg(F))
    return (np.asarray(el.to_global(out)),)


def _agree(got, want, tol=1e-10):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("name", ["square", "tall", "wide", "complex",
                                  "ill"])
def test_polar_matches_jax(rc, name):
    F = _inputs(name)
    U, H = et.polar(_tg(F, rc))
    Ug, Hg = _t(U), _t(H)
    jU, jH = _jax("polar", name)
    _agree(Hg, jH)
    # U's forward error grows with the condition number (its derivative
    # carries 1 / (s_i + s_j)): at cond 1e10 two orderings of the same
    # sums may differ by ~eps * cond, so there it is held to that
    _agree(Ug, jU, 1e-10 if name != "ill"
           else np.finfo(float).eps * np.linalg.cond(F))
    m, n = F.shape
    k = min(m, n)
    gram = Ug.conj().T @ Ug if m >= n else Ug @ Ug.conj().T
    # tests/lapack/test_funcs.py's bounds
    if name == "ill":
        assert np.linalg.norm(gram - np.eye(k)) < 1e-10
        assert np.linalg.norm(Ug @ Hg - F) / np.linalg.norm(F) < 1e-12
        return
    assert np.linalg.norm(gram - np.eye(k)) < 1e-13
    assert np.linalg.norm(Ug @ Hg - F) / np.linalg.norm(F) \
        < (1e-13 if name == "wide" else 1e-14)
    assert np.linalg.norm(Hg - Hg.conj().T) < 1e-13
    assert np.min(np.linalg.eigvalsh(Hg)) > -1e-12


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_sign_matches_jax(rc):
    A, S_true = _inputs("sign")
    Sg = _t(et.sign(_tg(A, rc)))
    _agree(Sg, _jax("sign", "sign")[0])
    assert np.linalg.norm(Sg - S_true) / np.linalg.norm(S_true) < 1e-10
    assert np.linalg.norm(Sg @ Sg - np.eye(16)) < 1e-10


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_inverses_match_jax(rc):
    F = _inputs("general")
    X = _t(et.inverse(_tg(F, rc)))
    _agree(X, _jax("inverse", "general")[0])
    assert np.linalg.norm(F @ X - np.eye(24)) < 1e-12
    for uplo, name in (("L", "lower"), ("U", "upper")):
        T = _inputs(name)
        X = _t(et.triangular_inverse(uplo, _tg(T, rc)))
        _agree(X, _jax("triangular_inverse", name)[0])
        tri = np.tril if uplo == "L" else np.triu
        assert np.linalg.norm(tri(X) @ T - np.eye(24)) < 1e-12
    P = _inputs("hpd")
    X = _t(et.hpd_inverse(_tg(P, rc)))
    _agree(X, _jax("hpd_inverse", "hpd")[0])
    assert np.linalg.norm(P @ X - np.eye(24)) < 1e-12


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_pseudoinverse_matches_jax(rc):
    F = _inputs("pinv_tall")
    P = _t(et.pseudoinverse(_tg(F, rc)))
    _agree(P, _jax("pseudoinverse", "pinv_tall")[0])
    assert np.linalg.norm(P @ F - np.eye(16)) < 1e-10
    B = _inputs("pinv_rank")
    Pb = _t(et.pseudoinverse(_tg(B, rc)))
    assert np.linalg.norm(B @ Pb @ B - B) / np.linalg.norm(B) < 1e-10
    # the dropped directions differ between runs only by rounding; the
    # Moore-Penrose conditions pin the result, so compare through them
    _agree(B @ Pb, B @ _jax("pseudoinverse", "pinv_rank")[0])


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_square_roots_match_jax(rc):
    F = _inputs("hpd")
    Y = _t(et.square_root(_tg(F, rc)))
    _agree(Y, _jax("square_root", "hpd")[0])
    assert np.linalg.norm(Y @ Y - F) / np.linalg.norm(F) < 1e-11
    Y2 = _t(et.hpd_square_root(_tg(F, rc)))
    _agree(Y2, _jax("hpd_square_root", "hpd")[0])
    assert np.linalg.norm(Y2 @ Y2 - F) / np.linalg.norm(F) < 1e-11
    assert np.linalg.norm(Y2 - Y2.T) < 1e-11


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_qdwh_schedule_is_the_jax_schedule(dtype):
    eps = float(np.finfo(dtype).eps)
    for l0 in (eps, 1e-3, 0.5):
        assert tfuncs._qdwh_schedule(l0, 10 * eps) \
            == jfuncs._qdwh_schedule(l0, 10 * eps)
    # float32 at l0 = eps: the six steps of the SVD path, two of them QR
    sched = tfuncs._qdwh_schedule(eps, 10 * eps)
    if dtype is np.float32:
        assert len(sched) == 6
        assert sum(c > 100 for _, _, c in sched) == 2


def test_polar_degenerate_inputs_and_refusals():
    # a zero matrix runs the iteration (its norm is clamped to tiny) and
    # gives zero factors, as in the JAX package
    U, H = et.polar(_tg(np.zeros((6, 4)), (2, 2)))
    np.testing.assert_array_equal(_t(U), np.zeros((6, 4)))
    np.testing.assert_array_equal(_t(H), np.zeros((4, 4)))
    # a non-finite norm returns (I, 0) without iterating
    F = np.ones((6, 4))
    F[2, 1] = np.nan
    U, H = et.polar(_tg(F, (2, 2)))
    np.testing.assert_array_equal(_t(U), np.eye(6, 4))
    np.testing.assert_array_equal(_t(H), np.zeros((6, 4)))
    with pytest.raises(ValueError, match="square"):
        et.sign(_tg(np.ones((4, 3)), (1, 1)))
    with pytest.raises(ValueError, match="square"):
        et.inverse(_tg(np.ones((4, 3)), (1, 1)))


@pytest.mark.parametrize("name", [
    "polar", "sign", "inverse", "triangular_inverse", "hpd_inverse",
    "pseudoinverse", "square_root", "hpd_square_root", "svd", "herm_eig",
    "bidiag", "apply_p_bidiag", "hessenberg", "apply_q_hessenberg", "herk",
    "syrk", "trrk", "vstack", "hstack", "shift_diagonal", "get_diagonal",
    "diagonal_scale", "trace", "frobenius_norm"])
def test_public_signatures_match_the_jax_package(name):
    import inspect
    assert str(inspect.signature(getattr(et, name))) \
        == str(inspect.signature(getattr(el, name)))
