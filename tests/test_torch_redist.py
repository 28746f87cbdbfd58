"""The port's redistribution engine against the JAX engine: for the same
source matrix, ``redistribute``, ``transpose_dist`` and ``panel_spread``
give storage bit-equal to ``elemental_tpu``'s on 2x2 and 2x4 grids (the
port moves values through the global matrix, the JAX engine through
collectives; neither does arithmetic)."""
import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et

GRIDS = [(2, 2), (2, 4)]
MOVES = [(("MC", "MR"), ("STAR", "STAR")), (("MC", "MR"), ("VC", "STAR")),
         (("MC", "MR"), ("MC", "STAR")), (("MC", "MR"), ("STAR", "VR")),
         (("VC", "STAR"), ("MC", "MR")), (("STAR", "VR"), ("STAR", "MR")),
         (("STAR", "STAR"), ("MD", "STAR")), (("MC", "MR"), ("MR", "MC"))]


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _pair(mod, names):
    return mod.Dist[names[0]], mod.Dist[names[1]]


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("src,dst", MOVES,
                         ids=[f"{a[0]}{a[1]}-{b[0]}{b[1]}" for a, b in MOVES])
def test_redistribute_storage_bit_equal(rc, src, dst):
    F = np.random.default_rng(5).normal(size=(11, 9))
    jA = el.from_global(F, *_pair(el, src), jgrid(*rc))
    tA = et.from_global(F, *_pair(et, src), tgrid(*rc))
    jB = el.redistribute(jA, *_pair(el, dst))
    tB = et.redistribute(tA, *_pair(et, dst))
    assert (tB.cdist.value, tB.rdist.value) == dst
    assert np.array_equal(et.storage_numpy(tB), np.asarray(jB.local))


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("conj", [False, True])
def test_transpose_dist_bit_equal(rc, conj):
    rng = np.random.default_rng(6)
    F = rng.normal(size=(10, 7)) + 1j * rng.normal(size=(10, 7))
    jA = el.from_global(F, el.MC, el.STAR, jgrid(*rc))
    tA = et.from_global(F, et.MC, et.STAR, tgrid(*rc))
    jT = el.transpose_dist(jA, conj=conj)
    tT = et.transpose_dist(tA, conj=conj)
    assert tT.dist == (et.STAR, et.MC) and tT.gshape == jT.gshape
    assert np.array_equal(et.storage_numpy(tT), np.asarray(jT.local))


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("conj", [False, True])
def test_panel_spread_bit_equal(rc, conj):
    rng = np.random.default_rng(7)
    F = rng.normal(size=(13, 4)) + 1j * rng.normal(size=(13, 4))
    jA = el.from_global(F, el.VC, el.STAR, jgrid(*rc))
    tA = et.from_global(F, et.VC, et.STAR, tgrid(*rc))
    jmc, jmr = el.panel_spread(jA, conj=conj)
    tmc, tmr = et.panel_spread(tA, conj=conj)
    assert tmc.dist == (et.MC, et.STAR) and tmr.dist == (et.STAR, et.MR)
    assert np.array_equal(et.storage_numpy(tmc), np.asarray(jmc.local))
    assert np.array_equal(et.storage_numpy(tmr), np.asarray(jmr.local))


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_star_star_bridges(rc):
    """``to_star_star`` is the gathered global matrix (the JAX engine's
    redistribute to [STAR,STAR]); ``_from_star_star`` filters it back."""
    from elemental_tpu_torch.redist.engine import _from_star_star, to_star_star
    F = np.random.default_rng(8).normal(size=(9, 10))
    jA = el.from_global(F, el.VC, el.STAR, jgrid(*rc))
    tA = et.from_global(F, et.VC, et.STAR, tgrid(*rc))
    star = to_star_star(tA)
    assert star.dist == (et.STAR, et.STAR)
    assert np.array_equal(et.storage_numpy(star),
                          np.asarray(el.redistribute(jA, el.STAR, el.STAR).local))
    back = _from_star_star(star.local, (9, 10), et.MC, et.MR, 0, 0, tA.grid)
    assert np.array_equal(et.storage_numpy(back),
                          np.asarray(el.redistribute(jA, el.MC, el.MR).local))


def test_one_by_one_redistribute_retags_without_copy():
    F = np.arange(12.0).reshape(4, 3)
    A = et.from_global(F, et.MC, et.MR, tgrid(1, 1))
    B = et.redistribute(A, et.VC, et.STAR)
    assert B.dist == (et.VC, et.STAR) and B.local is A.local


def test_later_slice_knobs_raise():
    A = et.from_global(np.eye(4), et.MC, et.MR, tgrid(2, 2))
    with pytest.raises(NotImplementedError, match="later slice"):
        et.redistribute(A, et.STAR, et.STAR, comm_precision="bf16")
    with pytest.raises(NotImplementedError, match="later slice"):
        et.redistribute(A, et.STAR, et.STAR, path="direct")
