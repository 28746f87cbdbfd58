"""The port's blocked ``trsm`` against ``elemental_tpu.trsm``: the four left
cases ``cholesky_solve_after`` uses and one right-side case, float64, on
1x1 and 2x4 grids, to rtol 1e-12 (the same blocked sweep; only the
diagonal-block solver's rounding differs)."""
import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et

GRIDS = [(1, 1), (2, 4)]
CASES = [("L", "L", "N"), ("L", "L", "C"), ("L", "U", "N"), ("L", "U", "C"),
         ("R", "L", "C")]


def _tri(n, uplo, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    A = np.tril(A) if uplo == "L" else np.triu(A)
    return A + 2 * n * np.eye(n)            # well conditioned


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("side,uplo,orient", CASES,
                         ids=["".join(c) for c in CASES])
def test_trsm_matches_jax(rc, side, uplo, orient):
    n, nrhs = 21, 5
    A = _tri(n, uplo, seed=11).real
    shape = (n, nrhs) if side == "L" else (nrhs, n)
    B = np.random.default_rng(12).normal(size=shape)
    jg = el.Grid(jax.devices()[: rc[0] * rc[1]], height=rc[0])
    tg = et.Grid(*rc, device="cpu")
    jX = el.trsm(side, uplo, orient, el.from_global(A, el.MC, el.MR, jg),
                 el.from_global(B, el.MC, el.MR, jg), nb=8)
    tX = et.trsm(side, uplo, orient, et.from_global(A, et.MC, et.MR, tg),
                 et.from_global(B, et.MC, et.MR, tg), nb=8)
    want = np.asarray(el.to_global(jX))
    got = et.to_global(tX).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    opA = A.T if orient in ("T", "C") else A
    resid = opA @ got - B if side == "L" else got @ opA - B
    assert np.linalg.norm(resid) < 1e-12 * np.linalg.norm(B) * n


def test_trsm_complex_conj_case():
    n = 12
    A = _tri(n, "L", seed=13)
    B = np.random.default_rng(14).normal(size=(n, 3)) + 0j
    tg = et.Grid(2, 2, device="cpu")
    X = et.trsm("L", "L", "C", et.from_global(A, et.MC, et.MR, tg),
                et.from_global(B, et.MC, et.MR, tg), nb=4)
    np.testing.assert_allclose(A.conj().T @ et.to_global(X).numpy(), B,
                               rtol=0, atol=1e-12)


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


def test_trsm_later_slice_knobs_raise(empty_tune_cache):
    """``'auto'`` for ``nb`` / ``comm_precision`` resolves as op
    ``'trsm'`` on B's shape to the JAX package's value; each call equals
    the explicit one."""
    tg = et.Grid(device="cpu")
    A = et.from_global(np.eye(4), et.MC, et.MR, tg)
    jA = el.from_global(np.eye(4), el.MC, el.MR,
                        el.Grid(jax.devices()[:1], height=1))
    base = {"nb": None, "comm_precision": None, "redist_path": None}
    for kw in ({"nb": "auto"}, {"comm_precision": "auto"}):
        (k, _), = kw.items()
        kn = et.tune.resolve_knobs("trsm", gshape=A.gshape, dtype=A.dtype,
                                   grid=tg, knobs={**base, **kw})
        jn = el.tune.resolve_knobs("trsm", gshape=A.gshape,
                                   dtype=np.float64, grid=jA.grid,
                                   knobs={**base, **kw})
        assert kn[k] == jn[k] and kn[k] != "auto"
        assert np.array_equal(
            et.trsm("L", "L", "N", A, A, **kw).local.numpy(),
            et.trsm("L", "L", "N", A, A, **{k: kn[k]}).local.numpy())
