"""The port's ``lu`` / ``lu_solve`` against ``elemental_tpu`` on 1x1, 2x2
and 2x4 grids: the same numpy inputs from a seed go through both
packages.  At float64 the permutations are equal and the packed factors
agree to 1e-12 of their largest entry (the schedules are the same; the
triangular solves and products round in different libraries); the
look-ahead and classic orders agree to the same bound."""
import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]
#: one square size and block size for every JAX comparison, so the JAX
#: side compiles its per-step operations once
N, NB = 24, 8


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _mat(shape, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=shape)
    if np.issubdtype(dtype, np.complexfloating):
        F = F + 1j * rng.normal(size=shape)
    return F.astype(dtype)


def _both(F, rc):
    return (el.from_global(F, el.MC, el.MR, jgrid(*rc)),
            et.from_global(F, et.MC, et.MR, tgrid(*rc)))


def _close(got, want, rtol=1e-12):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("lookahead,crossover",
                         [(True, None), (True, 0), (False, None), (False, 0)],
                         ids=["la-xdefault", "la-x0", "classic-xdefault",
                              "classic-x0"])
def test_lu_matches_jax(rc, lookahead, crossover):
    F = _mat((N, N), seed=1)
    jA, tA = _both(F, rc)
    before = tA.local.clone()
    kw = dict(nb=NB, lookahead=lookahead, crossover=crossover)
    jLU, jperm = el.lu(jA, **kw)
    tLU, tperm = et.lu(tA, **kw)
    assert torch.equal(tA.local, before)          # the input is untouched
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    _close(et.to_global(tLU).numpy(), np.asarray(el.to_global(jLU)))


@pytest.mark.parametrize("rc", [(1, 1), (2, 4)], ids=["1x1", "2x4"])
@pytest.mark.parametrize("shape,crossover", [((30, 20), 16), ((20, 30), 0)],
                         ids=["tall-x16", "wide-x0"])
def test_lu_rectangular_matches_jax(rc, shape, crossover):
    F = _mat(shape, seed=2)
    jA, tA = _both(F, rc)
    jLU, jperm = el.lu(jA, nb=NB, crossover=crossover)
    tLU, tperm = et.lu(tA, nb=NB, crossover=crossover)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    _close(et.to_global(tLU).numpy(), np.asarray(el.to_global(jLU)))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_lookahead_matches_classic(rc):
    A = et.from_global(_mat((37, 37), seed=3), et.MC, et.MR, tgrid(*rc))
    La, pa = et.lu(A, nb=8, lookahead=True, crossover=0)
    Lb, pb = et.lu(A, nb=8, lookahead=False)
    assert torch.equal(pa, pb)
    _close(et.to_global(La).numpy(), et.to_global(Lb).numpy())


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_lu_solve_matches_jax(rc):
    """The whole slice: LU + row permutation + the two sweeps."""
    F, B = _mat((N, N), 4), _mat((N, 5), 5)
    jg, tg = jgrid(*rc), tgrid(*rc)
    jX = el.lu_solve(el.from_global(F, el.MC, el.MR, jg),
                     el.from_global(B, el.MC, el.MR, jg), nb=NB)
    tA = et.from_global(F, et.MC, et.MR, tg)
    tB = et.from_global(B, et.MC, et.MR, tg)
    a0, b0 = tA.local.clone(), tB.local.clone()
    tX = et.lu_solve(tA, tB, nb=NB)
    assert torch.equal(tA.local, a0) and torch.equal(tB.local, b0)
    got = et.to_global(tX).numpy()
    _close(got, np.asarray(el.to_global(jX)))
    assert np.linalg.norm(F @ got - B) < 1e-12 * np.linalg.norm(B)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_lu_solve_complex(rc):
    F, B = _mat((30, 30), 14, np.complex128), _mat((30, 4), 15, np.complex128)
    tg = tgrid(*rc)
    X = et.lu_solve(et.from_global(F, et.MC, et.MR, tg),
                    et.from_global(B, et.MC, et.MR, tg), nb=8)
    _close(et.to_global(X).numpy(), np.linalg.solve(F, B), 1e-10)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_lu_solve_after_reuse(rc):
    n = 24
    F = _mat((n, n), seed=6)
    tg = tgrid(*rc)
    LU, perm = et.lu(et.from_global(F, et.MC, et.MR, tg), nb=8)
    for seed in (7, 8):
        B = _mat((n, 3), seed=seed)
        X = et.lu_solve_after(LU, perm, et.from_global(B, et.MC, et.MR, tg),
                              nb=8)
        _close(et.to_global(X).numpy(), np.linalg.solve(F, B), 1e-10)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_permute_rows_and_cols_match_jax(rc):
    F = _mat((13, 9), seed=9)
    jA, tA = _both(F, rc)
    rperm = np.random.default_rng(10).permutation(13)
    cperm = np.random.default_rng(11).permutation(9)
    for inverse in (False, True):
        jR = el.permute_rows(jA, jax.numpy.asarray(rperm), inverse=inverse)
        tR = et.permute_rows(tA, torch.as_tensor(rperm), inverse=inverse)
        assert np.array_equal(et.storage_numpy(tR), np.asarray(jR.local))
        jC = el.permute_cols(jA, jax.numpy.asarray(cperm), inverse=inverse)
        tC = et.permute_cols(tA, torch.as_tensor(cperm), inverse=inverse)
        assert np.array_equal(et.storage_numpy(tC), np.asarray(jC.local))
    back = et.permute_rows(et.permute_rows(tA, torch.as_tensor(rperm)),
                           torch.as_tensor(rperm), inverse=True)
    assert np.array_equal(et.to_global(back).numpy(), F)


def test_calu_on_a_single_row_grid_is_classic():
    F = _mat((24, 24), seed=12)
    A = et.from_global(F, et.MC, et.MR, tgrid(1, 4))
    La, pa = et.lu(A, nb=8, panel="calu")
    Lb, pb = et.lu(A, nb=8)
    assert torch.equal(pa, pb) and torch.equal(La.local, Lb.local)


def test_panel_impl_torch_and_inners_match_default_on_cpu():
    A = et.from_global(_mat((40, 40), seed=13), et.MC, et.MR, tgrid(1, 1))
    La, pa = et.lu(A, nb=16)
    Lb, pb = et.lu(A, nb=16, panel_impl="torch", inners=(8, 4))
    assert torch.equal(pa, pb)
    _close(Lb.local.numpy(), La.local.numpy())


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


_LU_KNOBS = {"nb": None, "lookahead": True, "crossover": None,
             "panel": "classic", "panel_impl": None, "comm_precision": None,
             "redist_path": None}


@pytest.mark.parametrize("kw", [
    dict(nb="auto"), dict(lookahead="auto"), dict(crossover="auto"),
    dict(panel="auto"), dict(comm_precision="auto"),
    dict(redist_path="auto"), dict(timer=object()),
    dict(health=True, timer=object()), dict(abft=True, timer=object()),
    dict(precision="bf16"), dict(update_precision="bf16")],
    ids=lambda kw: next(iter(kw)))
def test_later_slice_knobs_raise(kw, empty_tune_cache):
    """``timer`` raises.  Each ``'auto'`` knob resolves through the tuner,
    as in the JAX package, to the JAX package's value, and the call equals
    the explicit call with the resolved value.  ``health`` and ``abft``
    are ported: beside ``timer`` the call still raises (the guarded driver
    would otherwise take it as its hook), and alone each knob reaches its
    monitor or its guarded driver, which files a fresh report."""
    A = et.from_global(_mat((8, 8)), et.MC, et.MR, tgrid(1, 1))
    knob = next(iter(kw))
    if kw[knob] == "auto":
        knobs = {**_LU_KNOBS, **kw}
        kn = et.tune.resolve_knobs("lu", gshape=A.gshape, dtype=A.dtype,
                                   grid=A.grid, knobs=knobs)
        jn = el.tune.resolve_knobs("lu", gshape=A.gshape, dtype=np.float64,
                                   grid=jgrid(1, 1), knobs=knobs)
        assert kn[knob] == jn[knob] and kn[knob] != "auto"
        LUa, pa = et.lu(A, **kw)
        LUe, pe = et.lu(A, **{knob: kn[knob]})
        assert torch.equal(pa, pe) and torch.equal(LUa.local, LUe.local)
        return
    with pytest.raises(NotImplementedError, match="later slice"):
        et.lu(A, **kw)
    if knob in ("health", "abft"):
        last = {"health": et.resilience.last_health_report,
                "abft": et.resilience.last_abft_report}[knob]
        before = last("lu")
        et.lu(A, **{knob: True})
        rep = last("lu")
        assert rep is not before and rep["driver"] == "lu" and rep["ok"]


def test_calu_on_a_multi_row_grid_and_info_raise(empty_tune_cache):
    g = tgrid(2, 2)
    A = et.from_global(_mat((8, 8)), et.MC, et.MR, g)
    B = et.from_global(np.ones((8, 1)), et.MC, et.MR, g)
    # CALU runs on a multi-row grid: a valid factorization of A
    LU_, perm = et.lu(A, panel="calu", nb=4)
    F = et.to_global(LU_).numpy()
    L, U = np.tril(F, -1) + np.eye(8), np.triu(F)
    np.testing.assert_allclose(L @ U, _mat((8, 8))[perm.numpy()], atol=1e-12)
    # nb='auto' beside info=True resolves as in the JAX package: the
    # factor as op 'lu', the sweeps as op 'trsm'
    Xa, info = et.lu_solve(A, B, nb="auto", info=True)
    nb_l = et.tune.resolve_knobs("lu", gshape=A.gshape, dtype=A.dtype,
                                 grid=g, knobs={**_LU_KNOBS, "nb": "auto"})
    nb_t = et.tune.resolve_knobs("trsm", gshape=B.gshape, dtype=B.dtype,
                                 grid=g, knobs={"nb": "auto",
                                                "comm_precision": None,
                                                "redist_path": None})
    LUe, pe = et.lu(A, nb=nb_l["nb"])
    Xe = et.lu_solve_after(LUe, pe, B, nb=nb_t["nb"])
    assert torch.equal(Xa.local, Xe.local) and not info["singular"]
    with pytest.raises(ValueError, match="panel strategy"):
        et.lu(A, panel="tree")
