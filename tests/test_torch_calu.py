"""CALU: tournament-pivoted LU on the virtual grid, against the JAX
package (mirroring ``tests/lapack/test_lu_calu.py``).

The tournament permutation is exactly the JAX package's (the slab
sweeps, the playoffs and the winners' composition), the unpivoted
refactorization and the whole ``lu(panel='calu')`` agree to 1e-12
(float64; JAX references on 2x2, where no collective can time out), and
the one-psum row-block solve agrees to 1e-6 relative in float32 on a
bfloat16 payload (its sum order over grid rows may differ from XLA's
psum).  The port alone then covers the 2x4 and 4x1 grids: PA = LU, the
stability suite against the classic panel, and ``lu_solve`` through both
panels on 1x1, 2x2, 2x4 and 4x1.  Last, the redistribution counts that
``chip_smoke.py`` phase 3i checks on the card are pinned here to the
JAX package's trace at the same panel count and crossover ratio."""
import importlib
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.analysis.drivers import trace_driver
from elemental_tpu_torch.redist import engine as t_engine

jlu = importlib.import_module("elemental_tpu.lapack.lu")
tlu = importlib.import_module("elemental_tpu_torch.lapack.lu")

#: the JAX suite's stability bound (tests/lapack/test_lu_calu.py)
CALU_RESIDUAL_FACTOR = 64.0
_FLOOR = 1e-14
GRIDS = [(1, 1), (2, 2), (2, 4), (4, 1)]


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _whole(fn, *args):
    """A JAX reference compiled as one program.  Run eagerly, each op of
    the blocked loops compiles on its own, which took most of this file's
    time on the CPU; the compiled program gives the same numbers."""
    return jax.jit(fn)(*args)


def _resid(F, LUd, perm):
    LUh = et.to_global(LUd).numpy()
    m, n = LUh.shape
    k = min(m, n)
    L = np.tril(LUh[:, :k], -1) + np.eye(m, k)
    U = np.triu(LUh[:k, :])
    p = perm.numpy()
    assert sorted(p.tolist()) == list(range(m))
    return np.linalg.norm(F[p, :] - L @ U) / np.linalg.norm(F)


@pytest.mark.parametrize("r", [2, 3, 4, 5])
@pytest.mark.parametrize("shape,nbw", [((40, 8), 8), ((19, 8), 8),
                                       ((64, 16), 16), ((12, 6), 6)])
def test_tournament_permutation_is_jax_exactly(r, shape, nbw):
    P = np.random.default_rng(60 + r).normal(size=shape)
    want = np.asarray(_whole(lambda p: jlu._tournament_pivots(p, nbw, r),
                             jnp.asarray(P)))
    got = tlu._tournament_pivots(torch.as_tensor(P), nbw, r)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


def test_tournament_on_singular_and_padded_panels():
    """Zero columns and zero slabs: the guarded divisions and the padding
    sentinel's no-op swaps give JAX's permutation too."""
    rng = np.random.default_rng(3)
    P = rng.normal(size=(30, 6))
    P[:, 2] = 0.0
    P[::4] = 0.0
    for r in (2, 4, 7):
        want = np.asarray(_whole(lambda p: jlu._tournament_pivots(p, 6, r),
                                 jnp.asarray(P)))
        assert np.array_equal(
            tlu._tournament_pivots(torch.as_tensor(P), 6, r).numpy(), want)


def test_playoff_sweep_is_jax_exactly():
    V = np.random.default_rng(4).normal(size=(3, 20, 6))
    want = np.stack([np.asarray(jlu._playoff_perm(jnp.asarray(v), 6))
                     for v in V])
    assert np.array_equal(tlu._playoff_perm(torch.as_tensor(V), 6), want)


@pytest.mark.parametrize("r", [1, 2, 4])
def test_calu_panel_matches_jax(r):
    P = np.random.default_rng(5).normal(size=(48, 8))
    jPf, jperm = _whole(lambda p: jlu._calu_panel(p, 8, r), jnp.asarray(P))
    tPf, tperm = tlu._calu_panel(torch.as_tensor(P), 8, r)
    assert np.array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_allclose(tPf.numpy(), np.asarray(jPf), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(jPf)).max())


@pytest.mark.parametrize("kw", [dict(), dict(lookahead=False),
                                dict(crossover=8), dict(crossover=0)],
                         ids=["default", "classic-order", "xover8", "xover0"])
@pytest.mark.parametrize("shape", [(24, 24), (32, 20), (20, 32), (19, 19)])
def test_calu_lu_matches_jax_on_2x2(kw, shape):
    F = np.random.default_rng(61).normal(size=shape)
    jLU, jp = _whole(lambda a: jlu.lu(a, nb=8, panel="calu", **kw),
                     el.from_global(F, el.MC, el.MR, jgrid(2, 2)))
    tLU, tp = et.lu(et.from_global(F, et.MC, et.MR, tgrid(2, 2)), nb=8,
                    panel="calu", **kw)
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(et.storage_numpy(tLU), np.asarray(jLU.local),
                               rtol=0, atol=1e-12 * np.abs(F).max())


@pytest.mark.parametrize("wire", [None, "bf16"])
def test_rowblock_solve_matches_jax(wire):
    """U = Li11 @ A12 landing [STAR,MR] in one psum: float64 to 1e-12
    without a wire, float32 on the bfloat16 payload to 1e-6 relative."""
    dt = np.float64 if wire is None else np.float32
    rng = np.random.default_rng(62)
    nbw, w = 8, 20
    A = rng.normal(size=(nbw, w)).astype(dt)
    Li = np.tril(rng.normal(size=(nbw, nbw))).astype(dt) + np.eye(nbw, dtype=dt)
    jU = jlu._rowblock_solve_jit(el.from_global(A, el.MC, el.MR, jgrid(2, 2)),
                                 jnp.asarray(Li), jax.lax.Precision.HIGHEST,
                                 wire)
    tU = tlu._rowblock_solve(et.from_global(A, et.MC, et.MR, tgrid(2, 2)),
                             torch.as_tensor(Li), wire)
    assert tU.dist == (et.STAR, et.MR)
    ref = np.asarray(jU.local)
    tol = 1e-12 if wire is None else 1e-6
    np.testing.assert_allclose(et.storage_numpy(tU), ref, rtol=0,
                               atol=tol * np.abs(ref).max())
    if wire is None:
        np.testing.assert_allclose(et.to_global(tU).numpy(), Li @ A,
                                   rtol=1e-12)


@pytest.mark.parametrize("rc", [(2, 2), (2, 4), (4, 1), (3, 2)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("shape", [(24, 24), (32, 20), (20, 32), (19, 19),
                                   (19, 32), (32, 19), (18, 30)])
def test_calu_residual(rc, shape):
    F = np.random.default_rng(61).normal(size=shape)
    LUd, perm = et.lu(et.from_global(F, et.MC, et.MR, tgrid(*rc)), nb=8,
                      panel="calu")
    assert _resid(F, LUd, perm) < 1e-13


@pytest.mark.parametrize("rc", [(1, 8), (1, 1)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_calu_degenerates_to_classic_on_single_row_grid(rc):
    F = np.random.default_rng(64).normal(size=(24, 24))
    g = tgrid(*rc)
    LUa, pa = et.lu(et.from_global(F, et.MC, et.MR, g), nb=8, panel="calu",
                    lookahead=False)
    LUb, pb = et.lu(et.from_global(F, et.MC, et.MR, g), nb=8,
                    panel="classic", lookahead=False)
    assert torch.equal(pa, pb)
    np.testing.assert_allclose(et.to_global(LUa).numpy(),
                               et.to_global(LUb).numpy(), rtol=1e-13,
                               atol=1e-13)


def _stability_cases(n):
    rng = np.random.default_rng(65)
    grade = np.logspace(0, -6, n)
    wilk = np.eye(n) + np.tril(-np.ones((n, n)), -1)
    wilk[:, -1] = 1.0
    return {"random": rng.normal(size=(n, n)),
            "graded": grade[:, None] * rng.normal(size=(n, n))
            * grade[None, :],
            "wilkinson": wilk}


@pytest.mark.parametrize("rc", [(2, 4), (4, 1)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("case", ["random", "graded", "wilkinson"])
def test_calu_stability_vs_classic(rc, case):
    F = _stability_cases(32)[case]
    g = tgrid(*rc)
    LUc, pc = et.lu(et.from_global(F, et.MC, et.MR, g), nb=8,
                    panel="classic", lookahead=False)
    LUt, pt = et.lu(et.from_global(F, et.MC, et.MR, g), nb=8, panel="calu",
                    lookahead=False)
    assert _resid(F, LUt, pt) <= \
        CALU_RESIDUAL_FACTOR * _resid(F, LUc, pc) + _FLOOR


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("panel", ["classic", "calu"])
def test_lu_solve_through_both_panels(rc, panel):
    n, nrhs = 24, 4
    rng = np.random.default_rng(66)
    F = rng.normal(size=(n, n)) + n * np.eye(n)
    B = rng.normal(size=(n, nrhs))
    g = tgrid(*rc)
    X = et.lu_solve(et.from_global(F, et.MC, et.MR, g),
                    et.from_global(B, et.MC, et.MR, g), nb=8, panel=panel)
    Xh = et.to_global(X).numpy()
    assert np.linalg.norm(F @ Xh - B) / np.linalg.norm(B) < 1e-12


def test_calu_lu_solve_after_reuse_and_permute_roundtrip():
    n = 24
    rng = np.random.default_rng(67)
    F = rng.normal(size=(n, n)) + n * np.eye(n)
    g = tgrid(2, 4)
    LUd, perm = et.lu(et.from_global(F, et.MC, et.MR, g), nb=8, panel="calu")
    for seed in (1, 2):
        B = np.random.default_rng(seed).normal(size=(n, 2))
        X = et.lu_solve_after(LUd, perm, et.from_global(B, et.MC, et.MR, g),
                              nb=8)
        assert np.linalg.norm(F @ et.to_global(X).numpy() - B) \
            < 1e-12 * np.linalg.norm(B)
    B = rng.normal(size=(n, 5))
    Bp = et.permute_rows(et.from_global(B, et.MC, et.MR, g), perm)
    np.testing.assert_array_equal(et.to_global(Bp).numpy(), B[perm.numpy()])
    back = et.permute_rows(Bp, perm, inverse=True)
    np.testing.assert_array_equal(et.to_global(back).numpy(), B)


def test_calu_rejects_unknown_panel():
    A = et.from_global(np.eye(16), et.MC, et.MR, tgrid(2, 4))
    with pytest.raises(ValueError, match="panel"):
        et.lu(A, nb=8, panel="tournament")


def test_tournament_never_reaches_the_panel_kernel(monkeypatch):
    """On r > 1 the tournament panels bypass the classic panel; only the
    crossover tail's panels go through it (the kernel on the card)."""
    seen = []
    real = tlu._panel_dispatch
    monkeypatch.setattr(tlu, "_panel_dispatch",
                        lambda P, *a, **k: seen.append(P.shape) or
                        real(P, *a, **k))
    F = np.random.default_rng(2).normal(size=(64, 64))
    et.lu(et.from_global(F, et.MC, et.MR, tgrid(4, 1)), nb=16, panel="calu",
          crossover=32)
    assert seen == [(32, 16), (16, 16)]             # the 32 x 32 tail


def _labels(log):
    return dict(Counter(r.label for r in log))


@pytest.mark.parametrize("name,pin", [
    ("lu_calu", "CALU_LU_COUNTS"), ("qr_tsqr", "TSQR_QR_COUNTS")])
def test_smoke_counts_pinned_to_the_jax_trace(name, pin):
    """``chip_smoke.py`` phase 3i runs CALU at N = 32768, nb = 2048 with
    the default crossover (4096) and TSQR at 65536 x 32768, nb = 2048 on
    the 4x1 grid: 16 panels each, the tail at 1/8 of N.  The JAX trace of
    the registry's driver at n = 256, nb = 16 (crossover 32) has the same
    panel count and ratio; its label counts are the script's pins, and
    the port's run on the CPU gives them too."""
    _, _, log = trace_driver(name, jgrid(4, 1), n=256, nb=16)
    assert _labels(log) == getattr(chip_smoke, pin)
    F = np.random.default_rng(0).normal(size=(256, 256)).astype(np.float32)
    A = et.from_global(F, et.MC, et.MR, tgrid(4, 1))
    with t_engine.redist_trace() as tl:
        if name == "lu_calu":
            et.lu(A, nb=16, panel="calu", crossover=32)
        else:
            et.qr(A, nb=16, panel="tsqr")
    assert _labels(tl) == getattr(chip_smoke, pin)


def test_int8_wire_keeps_rounds_and_cuts_bytes():
    """Phase 3i's int8 check at the CPU size: equal total rounds, at
    least 1.9x fewer wire bytes than the full-precision run (the JAX
    README's claim for lu_calu_commq)."""
    F = np.random.default_rng(0).normal(size=(256, 256)).astype(np.float32)
    A = et.from_global(F, et.MC, et.MR, tgrid(4, 1))
    with t_engine.redist_trace() as full:
        et.lu(A, nb=16, panel="calu", crossover=32)
    with t_engine.redist_trace() as q8:
        et.lu(A, nb=16, panel="calu", crossover=32, comm_precision="int8")
    assert chip_smoke.wire_totals(q8)[0] == chip_smoke.wire_totals(full)[0]
    assert chip_smoke.wire_totals(full)[1] >= \
        1.9 * chip_smoke.wire_totals(q8)[1]
