"""The port's rank-k updates ``herk`` / ``syrk`` / ``trrk`` against
``elemental_tpu`` on 1x1, 2x2 and 2x4 grids: the same numpy inputs from a
seed go through both packages.  The updated triangle agrees to 1e-13, the
other triangle is C's storage bit for bit.  Mirrors
``tests/blas/test_level3.py::test_herk`` / ``test_syrk`` / ``test_trrk``.
"""
import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.blas import level3 as jl3

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _both(F, rc, dist=("MC", "MR")):
    return (el.from_global(F, *(getattr(el, d) for d in dist),
                           grid=jgrid(*rc)),
            et.from_global(F, *(getattr(et, d) for d in dist),
                           grid=tgrid(*rc)))


def _cplx(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _check(out, jout, C0, uplo, tol=1e-13):
    got = et.to_global(out).numpy()
    want = np.asarray(el.to_global(jout))
    tri = np.tril if uplo == "L" else np.triu
    np.testing.assert_allclose(tri(got), tri(want), rtol=0,
                               atol=tol * np.abs(want).max())
    # the other (strict) triangle is C's, bit for bit
    strict = (lambda x: np.triu(x, 1)) if uplo == "L" \
        else (lambda x: np.tril(x, -1))
    np.testing.assert_array_equal(strict(got), strict(C0))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("orient", ["N", "C"])
def test_herk_matches_jax(rc, uplo, orient):
    rng = np.random.default_rng(7)
    m, k = 18, 10
    A = _cplx(rng, m, k)
    Ain = A if orient == "N" else A.conj().T.copy()
    C0 = _cplx(rng, m, m)
    jA, tA = _both(Ain, rc)
    jC, tC = _both(C0, rc)
    out = et.herk(uplo, tA, alpha=2.0, beta=0.5, C=tC, orient=orient, nb=4)
    jout = jl3.herk(uplo, jA, alpha=2.0, beta=0.5, C=jC, orient=orient, nb=4)
    _check(out, jout, C0, uplo)
    want = 2.0 * A @ A.conj().T + 0.5 * C0
    tri = np.tril if uplo == "L" else np.triu
    np.testing.assert_allclose(tri(et.to_global(out).numpy()), tri(want),
                               rtol=1e-12)
    # C = None: the triangle of op(A) op(A)^H, zero elsewhere
    out = et.herk(uplo, tA, orient=orient, nb=8)
    _check(out, jl3.herk(uplo, jA, orient=orient, nb=8), np.zeros((m, m)),
           uplo)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("orient", ["N", "T"])
def test_syrk_matches_jax(rc, orient):
    rng = np.random.default_rng(8)
    m, k = 14, 9
    A = _cplx(rng, m, k)
    Ain = A if orient == "N" else A.T.copy()
    jA, tA = _both(Ain, rc)
    out = et.syrk("L", tA, orient=orient, nb=4)
    _check(out, jl3.syrk("L", jA, orient=orient, nb=4), np.zeros((m, m)),
           "L")
    np.testing.assert_allclose(np.tril(et.to_global(out).numpy()),
                               np.tril(A @ A.T), rtol=1e-12)
    C0 = rng.normal(size=(m, m))
    jC, tC = _both(C0.astype(complex), rc)
    out = et.syrk("U", tA, alpha=-1.0, beta=2.0, C=tC, orient=orient, nb=8)
    _check(out, jl3.syrk("U", jA, alpha=-1.0, beta=2.0, C=jC,
                         orient=orient, nb=8), C0.astype(complex), "U")


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_trrk_matches_jax(rc, uplo):
    rng = np.random.default_rng(9)
    m, k = 16, 8
    A = rng.normal(size=(m, k))
    B = rng.normal(size=(k, m))
    C0 = rng.normal(size=(m, m))
    jA, tA = _both(A, rc, ("MC", "STAR"))
    jB, tB = _both(B, rc, ("STAR", "MR"))
    jC, tC = _both(C0, rc)
    out = et.trrk(uplo, 2.0, tA, tB, 0.5, tC)
    _check(out, jl3.trrk(uplo, 2.0, jA, jB, 0.5, jC), C0, uplo)
    tri = np.tril if uplo == "L" else np.triu
    np.testing.assert_allclose(tri(et.to_global(out).numpy()),
                               tri(2.0 * A @ B + 0.5 * C0), rtol=1e-12)
    with pytest.raises(ValueError, match="trrk expects"):
        et.trrk(uplo, 1.0, tC, tB, 0.0, tC)


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


def test_herk_refuses_later_slice_knobs(empty_tune_cache):
    """Each ``'auto'`` knob resolves through the tuner to the JAX
    package's value, and the call equals the explicit one."""
    rng = np.random.default_rng(10)
    jA, tA = _both(rng.normal(size=(8, 4)), (1, 1))
    base = {"nb": None, "comm_precision": None, "redist_path": None}
    for kw in ({"nb": "auto"}, {"comm_precision": "auto"},
               {"redist_path": "auto"}):
        (k, _), = kw.items()
        kn = et.tune.resolve_knobs("herk", gshape=tA.gshape, dtype=tA.dtype,
                                   grid=tA.grid, knobs={**base, **kw})
        jn = el.tune.resolve_knobs("herk", gshape=tA.gshape,
                                   dtype=np.float64, grid=jA.grid,
                                   knobs={**base, **kw})
        assert kn[k] == jn[k] and kn[k] != "auto"
        got = et.herk("L", tA, **kw)
        assert np.array_equal(got.local.numpy(),
                              et.herk("L", tA, **{k: kn[k]}).local.numpy())
    with pytest.raises(ValueError, match="C shape"):
        et.herk("L", tA, C=et.from_global(np.zeros((4, 4)), et.MC, et.MR,
                                          grid=tgrid(1, 1)))
