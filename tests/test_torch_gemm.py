"""The port's SUMMA ``gemm``, ``trmm`` and the two-sided transforms against
``elemental_tpu`` on 1x1, 2x2 and 2x4 grids: the same numpy inputs from a
seed go through both packages.  Every schedule agrees with the JAX
package's to 1e-12 of the largest entry (float64 / complex128); the
two-sided transforms are also held to the oracles of
``tests/blas/test_level3_ext.py``."""
import jax
import numpy as np
import pytest
import scipy.linalg

import elemental_tpu as el
import elemental_tpu_torch as et

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]
ALGS = ["A", "B", "C", "dot", "gspmd", "slice"]


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _mat(shape, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=shape)
    if np.issubdtype(dtype, np.complexfloating):
        F = F + 1j * rng.normal(size=shape)
    return F.astype(dtype)


def _both(F, rc):
    return (el.from_global(F, el.MC, el.MR, jgrid(*rc)),
            et.from_global(F, et.MC, et.MR, tgrid(*rc)))


def _close(tA, jA, tol=1e-12):
    want = np.asarray(jA.local)
    np.testing.assert_allclose(et.storage_numpy(tA), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("alg", ALGS)
def test_gemm_every_alg_matches_jax(rc, alg):
    (jA, tA), (jB, tB) = _both(_mat((13, 9), 0), rc), _both(_mat((9, 11), 1), rc)
    out = et.gemm(tA, tB, alpha=1.5, alg=alg, nb=4)
    _close(out, el.gemm(jA, jB, alpha=1.5, alg=alg, nb=4))
    np.testing.assert_allclose(et.to_global(out).numpy(),
                               1.5 * _mat((13, 9), 0) @ _mat((9, 11), 1),
                               rtol=1e-12)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("oa,ob", [("N", "T"), ("T", "N"), ("C", "C"),
                                   ("T", "C")])
@pytest.mark.parametrize("alg", ["C", "dot"])
def test_gemm_orientations_match_jax(rc, oa, ob, alg):
    dt = np.complex128
    A = _mat((13, 9) if oa == "N" else (9, 13), 2, dt)
    B = _mat((9, 11) if ob == "N" else (11, 9), 3, dt)
    (jA, tA), (jB, tB) = _both(A, rc), _both(B, rc)
    out = et.gemm(tA, tB, orient_a=oa, orient_b=ob, alg=alg, nb=4)
    _close(out, el.gemm(jA, jB, orient_a=oa, orient_b=ob, alg=alg, nb=4))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("alg", ["A", "B", "dot", "slice"])
def test_gemm_beta_and_c_match_jax(rc, alg):
    dt = np.complex128
    (jA, tA), (jB, tB) = _both(_mat((13, 9), 4, dt), rc), \
        _both(_mat((9, 11), 5, dt), rc)
    jC, tC = _both(_mat((13, 11), 6, dt), rc)
    kw = dict(alpha=0.5 - 0.25j, beta=-1.5 + 0.5j, alg=alg, nb=4)
    out = et.gemm(tA, tB, C=tC, **kw)
    _close(out, el.gemm(jA, jB, C=jC, **kw))
    # a zero complex beta leaves a real C real
    (jAr, tAr), (jBr, tBr) = _both(_mat((13, 9), 7), rc), _both(_mat((9, 11), 8), rc)
    jCr, tCr = _both(_mat((13, 11), 9), rc)
    outr = et.gemm(tAr, tBr, beta=0j, C=tCr, alg=alg, nb=4)
    assert outr.dtype == tCr.dtype
    _close(outr, el.gemm(jAr, jBr, beta=0j, C=jCr, alg=alg, nb=4))


@pytest.fixture
def empty_tune_cache(tmp_path, monkeypatch):
    """Both packages' tuners on an empty cache (the cost model decides)."""
    from elemental_tpu.tune import cache as jc, policy as jp
    from elemental_tpu_torch.tune import cache as tc, policy as tp
    monkeypatch.setenv(jc.ENV_DIR, str(tmp_path / "jax"))
    monkeypatch.setenv(tc.ENV_DIR, str(tmp_path / "torch"))
    jp.clear_memo()
    tp.clear_memo()
    yield
    jp.clear_memo()
    tp.clear_memo()


def test_gemm_refuses_what_is_not_ported(empty_tune_cache):
    """The defaults (``alg='auto'``) resolve to ``'dot'`` on a 1x1 grid,
    as in the JAX package, and ``'auto'`` for ``nb`` / ``comm_precision``
    resolves to the JAX package's value; each equals the explicit call."""
    g = tgrid(1, 1)
    A = et.from_global(_mat((4, 4), 0), et.MC, et.MR, g)
    jA = el.from_global(_mat((4, 4), 0), el.MC, el.MR, jgrid(1, 1))
    assert np.array_equal(et.gemm(A, A).local.numpy(),
                          et.gemm(A, A, alg="dot").local.numpy())
    base = {"alg": "C", "nb": None, "comm_precision": None,
            "redist_path": None}
    for kw in ({"nb": "auto"}, {"comm_precision": "auto"}):
        (k, _), = kw.items()
        kn = et.tune.resolve_knobs("gemm", gshape=(4, 4, 4), dtype=A.dtype,
                                   grid=g, knobs={**base, **kw})
        jn = el.tune.resolve_knobs("gemm", gshape=(4, 4, 4),
                                   dtype=np.float64, grid=jA.grid,
                                   knobs={**base, **kw})
        assert kn[k] == jn[k] and kn[k] != "auto"
        assert np.array_equal(
            et.gemm(A, A, alg="C", **kw).local.numpy(),
            et.gemm(A, A, alg="C", **{k: kn[k]}).local.numpy())
    with pytest.raises(ValueError):
        et.gemm(A, A, alg="nope")
    with pytest.raises(TypeError):
        et.gemm(A, A, alpha=1j, alg="dot", C=A)     # complex into a real C


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("side,uplo,orient,unit", [
    ("L", "L", "N", False), ("L", "U", "C", True), ("R", "L", "T", True),
    ("R", "U", "N", False)])
def test_trmm_matches_jax_and_oracle(rc, side, uplo, orient, unit):
    dt = np.complex128
    T, B = _mat((8, 8), 10, dt), _mat((8, 8), 11, dt)
    (jT, tT), (jB, tB) = _both(T, rc), _both(B, rc)
    out = et.trmm(side, uplo, orient, tT, tB, alpha=2.0, unit=unit, nb=4)
    _close(out, el.trmm(side, uplo, orient, jT, jB, alpha=2.0, unit=unit,
                        nb=4))
    Tm = np.tril(T) if uplo == "L" else np.triu(T)
    if unit:
        np.fill_diagonal(Tm, 1.0)
    op = {"N": Tm, "T": Tm.T, "C": Tm.conj().T}[orient]
    want = 2.0 * (op @ B if side == "L" else B @ op)
    np.testing.assert_allclose(et.to_global(out).numpy(), want, rtol=1e-11)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_two_sided_trsm_matches_jax_and_scipy(rc, uplo):
    rng = np.random.default_rng(6)
    n = 8
    G = rng.normal(size=(n, n))
    A = G + G.T
    Fb = rng.normal(size=(n, n))
    B = Fb @ Fb.T / n + n * np.eye(n)
    (jA, tA), (jB, tB) = _both(A, rc), _both(B, rc)
    jF, tF = el.cholesky(jB, uplo, nb=4), et.cholesky(tB, uplo, nb=4)
    out = et.two_sided_trsm(uplo, tA, tF, nb=4)
    _close(out, el.two_sided_trsm(uplo, jA, jF, nb=4))
    got = np.sort(np.linalg.eigvalsh(et.to_global(out).numpy()))
    want = np.sort(scipy.linalg.eigh(A, B, eigvals_only=True))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_two_sided_trmm_matches_jax_and_oracle(rc, uplo):
    rng = np.random.default_rng(7)
    n = 8
    G = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    A = G + G.conj().T
    T = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    T = (np.tril(T) if uplo == "L" else np.triu(T)) + 2 * np.eye(n)
    (jA, tA), (jT, tT) = _both(A, rc), _both(T, rc)
    out = et.two_sided_trmm(uplo, tA, tT, nb=4)
    _close(out, el.two_sided_trmm(uplo, jA, jT, nb=4))
    want = T.conj().T @ A @ T if uplo == "L" else T @ A @ T.conj().T
    np.testing.assert_allclose(et.to_global(out).numpy(), want, rtol=1e-10,
                               atol=1e-10)
