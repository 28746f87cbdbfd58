"""The port's redistribution engine against the JAX engine: for the same
source matrix, ``redistribute``, ``transpose_dist``, ``panel_spread`` and
LU's row moves (``move_rows``, ``permute_rows_storage``) give storage
bit-equal to ``elemental_tpu``'s on 2x2 and 2x4 grids, and
``interior_view`` and ``interior_update`` give storage bit-equal to the
JAX package's for random offsets on 2x4 and 4x2 grids (and on 1x1 for
``interior_update``; the port moves values through the global
matrix or one storage gather, the JAX engine through collectives;
neither does arithmetic)."""
import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.redist import engine as jax_engine
from elemental_tpu.redist.interior import interior_update as jax_interior_update
from elemental_tpu.redist.interior import interior_view as jax_interior_view

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
    # a fresh view of the same storage: no copy, and the trace records an
    # output object distinct from the input, as the JAX engine's
    assert B.dist == (et.VC, et.STAR) and B.local is not A.local
    assert B.local.data_ptr() == A.local.data_ptr()


def test_later_slice_knobs_raise():
    """``comm_precision='auto'`` is not a wire: ``ValueError``, as the JAX
    engine's ``check_comm_precision``.  ``path='auto'`` arbitrates: the
    storage is bit-equal to the JAX engine's and to the chain's."""
    A = et.from_global(np.eye(4), et.MC, et.MR, tgrid(2, 2))
    jA = el.from_global(np.eye(4), el.MC, el.MR, jgrid(2, 2))
    with pytest.raises(ValueError, match="comm_precision"):
        et.redistribute(A, et.STAR, et.STAR, comm_precision="auto")
    with pytest.raises(ValueError, match="comm_precision"):
        el.redistribute(jA, el.STAR, el.STAR, comm_precision="auto")
    B = et.redistribute(A, et.STAR, et.STAR, path="auto")
    jB = el.redistribute(jA, el.STAR, el.STAR, path="auto")
    assert np.array_equal(B.local.numpy(), np.asarray(jB.local))
    assert np.array_equal(
        B.local.numpy(), et.redistribute(A, et.STAR, et.STAR).local.numpy())


@pytest.mark.parametrize("rc", [(1, 1)] + GRIDS,
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_move_rows_storage_bit_equal(rc):
    """LU's batched row move: padded target/source lists with invalid
    (sentinel) entries dropped, as the JAX engine's ``mode="drop"``."""
    F = np.random.default_rng(11).normal(size=(13, 6))
    jA = el.from_global(F, el.MC, el.MR, jgrid(*rc))
    tA = et.from_global(F, et.MC, et.MR, tgrid(*rc))
    targets = np.array([2, 7, 11, 4, 13, 13])      # 13 = out of range
    sources = np.array([7, 11, 2, 4, 0, 5])
    valid = targets < 13
    jB = jax_engine.move_rows(jA, jax.numpy.asarray(targets),
                      jax.numpy.asarray(sources), jax.numpy.asarray(valid))
    tB = et.move_rows(tA, targets, sources, valid)
    assert tB.local.shape == tA.local.shape
    assert np.array_equal(et.storage_numpy(tB), np.asarray(jB.local))


@pytest.mark.parametrize("rc", [(1, 1)] + GRIDS,
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("inverse", [False, True])
def test_permute_rows_storage_bit_equal(rc, inverse):
    F = np.random.default_rng(12).normal(size=(11, 7))
    perm = np.random.default_rng(13).permutation(11)
    jA = el.from_global(F, el.MC, el.MR, jgrid(*rc))
    tA = et.from_global(F, et.MC, et.MR, tgrid(*rc))
    jB = jax_engine.permute_rows_storage(jA, jax.numpy.asarray(perm), inverse=inverse)
    tB = et.permute_rows_storage(tA, perm, inverse=inverse)
    assert np.array_equal(et.storage_numpy(tB), np.asarray(jB.local))
    want = F[np.argsort(perm)] if inverse else F[perm]
    assert np.array_equal(et.to_global(tB).numpy(), want)


def test_permute_rows_storage_needs_zero_alignment():
    A = et.from_global(np.eye(4), et.MC, et.MR, tgrid(2, 2), calign=1)
    with pytest.raises(ValueError, match="zero alignments"):
        et.permute_rows_storage(A, np.arange(4))


INTERIOR_PAIRS = [("MC", "MR"), ("MR", "MC"), ("VC", "STAR"), ("STAR", "VR"),
                  ("MC", "STAR"), ("STAR", "STAR")]


@pytest.mark.parametrize("rc", [(2, 4), (4, 2)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("pair", INTERIOR_PAIRS,
                         ids=[f"{a}{b}" for a, b in INTERIOR_PAIRS])
def test_interior_view_storage_bit_equal(rc, pair):
    """Random (non-grain) offsets: the block is re-laid zero-aligned with
    zero padding, as the JAX package's rotation + slice gives it."""
    m, n = 13, 11
    F = np.random.default_rng(14).normal(size=(m, n))
    jA = el.from_global(F, *_pair(el, pair), jgrid(*rc))
    tA = et.from_global(F, *_pair(et, pair), tgrid(*rc))
    rng = np.random.default_rng(15)
    for _ in range(4):
        rs, re = sorted(rng.integers(0, m + 1, size=2))
        cs, ce = sorted(rng.integers(0, n + 1, size=2))
        rows, cols = (int(rs), int(re)), (int(cs), int(ce))
        jB = jax_interior_view(jA, rows, cols)
        tB = et.interior_view(tA, rows, cols)
        assert tB.dist == tA.dist and (tB.calign, tB.ralign) == (0, 0)
        assert tB.gshape == (re - rs, ce - cs)
        assert np.array_equal(et.storage_numpy(tB), np.asarray(jB.local))


def test_interior_view_one_by_one_and_bounds():
    F = np.random.default_rng(16).normal(size=(7, 5))
    tA = et.from_global(F, et.MC, et.MR, tgrid(1, 1))
    B = et.interior_view(tA, (2, 6), (1, 4))
    assert np.array_equal(et.to_global(B).numpy(), F[2:6, 1:4])
    B.local.zero_()
    assert np.array_equal(et.to_global(tA).numpy(), F)   # a copy, not a view
    with pytest.raises(ValueError, match="out of bounds"):
        et.interior_view(tA, (0, 8), (0, 5))
    shifted = et.from_global(F, et.MC, et.MR, tgrid(2, 2), calign=1)
    with pytest.raises(ValueError, match="zero alignment"):
        et.interior_view(shifted, (0, 2), (0, 2))


@pytest.mark.parametrize("rc", [(1, 1), (2, 4), (4, 2)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("pair", INTERIOR_PAIRS,
                         ids=[f"{a}{b}" for a, b in INTERIOR_PAIRS])
def test_interior_update_storage_bit_equal(rc, pair):
    """Random (non-grain) offsets: the block lands where the JAX package's
    rotations put it; the input matrix is left untouched."""
    m, n = 13, 11
    rng = np.random.default_rng(17)
    F = rng.normal(size=(m, n))
    jA = el.from_global(F, *_pair(el, pair), jgrid(*rc))
    tA = et.from_global(F, *_pair(et, pair), tgrid(*rc))
    for _ in range(3):
        h, w = int(rng.integers(1, m + 1)), int(rng.integers(1, n + 1))
        at = (int(rng.integers(0, m - h + 1)), int(rng.integers(0, n - w + 1)))
        G = rng.normal(size=(h, w))
        jB = el.from_global(G, *_pair(el, pair), jgrid(*rc))
        tB = et.from_global(G, *_pair(et, pair), tgrid(*rc))
        before = tA.local.clone()
        jA = jax_interior_update(jA, jB, at)
        tA2 = et.interior_update(tA, tB, at)
        assert bool((tA.local == before).all())
        tA = tA2
        assert np.array_equal(et.storage_numpy(tA), np.asarray(jA.local))
    with pytest.raises(ValueError, match="exceeds"):
        et.interior_update(tA, tB, (m - h + 1, 0))
