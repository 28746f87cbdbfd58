"""LU on the device grid: the row motion and psum collectives, the
arbitrary-offset extract, and ``lu`` / ``lu_solve`` / ``lu_solve_after`` /
``permute_rows`` with every rank's block on its own device (here
``Grid(r, c, devices=["cpu"] * (r * c))``; the panels run their plain
versions on the CPU).

Held against the JAX package (``el.Grid(jax.devices()[:r * c],
height=r)``) on 1x1, 2x2, 2x3 and 1x3 grids at odd shapes: ``move_rows``
(valid and sentinel entries), ``permute_rows_storage`` (both
``inverse``), ``permute_rows`` and ``interior_view`` (offset 0 and off the
stride) give tiles bit-equal to the JAX shards on the same mesh, rank by
rank; ``lu``
(look-ahead and classic order, the crossover at its default, never, mid
way and at the first step; square, tall and wide; CALU on 2x2 and 2x3,
its bfloat16 wire against the virtual grid) gives JAX's permutation and a
factor within 1e-12 relative of JAX's (on the 2x2 or 2x3 mesh,
:func:`_ref_grid`, :data:`CALU_JAX`) and of the port's virtual grid,
with the virtual grid's redistribution counts and records, and leaves
``A``'s tiles as they were; ``lu_solve`` and ``lu_solve_after`` agree
with JAX to 1e-12.  The byte tally of ``gather_rows`` and ``psum`` is
their closed form."""
import importlib
import types

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.redist import engine as jengine
from elemental_tpu_torch.core import ranks
from elemental_tpu_torch.redist import engine
from .torch_shared_ref import shared_cache
from .test_torch_device_grid import (GRIDS, GRID_IDS, _assert_tiles_are_shards,
                                     _close, _matrix, _records, dgrid, jgrid,
                                     vgrid)

tlu = importlib.import_module("elemental_tpu_torch.lapack.lu")

#: the layout tests' grid and shape, tall and wide in turn; lu's shapes:
#: square, wide and tall
LAYOUT_CASES = list(zip(GRIDS, [(37, 29), (29, 37)] * 2))
SHAPES = [(37, 37), (29, 37), (37, 23)]
SHAPE_IDS = [f"{m}x{n}" for m, n in SHAPES]
NB, NRHS = 16, 5


def _jit(fn, *args):
    """``fn`` of the JAX package under one ``jax.jit`` (eagerly every op
    of a driver compiles alone)."""
    return jax.jit(fn)(*args)


def _laid_out(jB):
    """A JAX DistMatrix with its storage sharded by its own spec: XLA may
    hand a jitted storage gather back in another sharding (GSPMD picked
    [None, 'mr'] for ``permute_rows_storage``), whose shards are not the
    ranks' blocks."""
    from jax.sharding import NamedSharding
    return jB.with_local(jax.device_put(
        jB.local, NamedSharding(jB.grid.mesh, jB.spec)))


def _index_lists(m: int, k: int, seed: int):
    """k distinct targets, their sources, and a validity mask with
    sentinel (out-of-range) entries where it is False."""
    rng = np.random.default_rng(seed)
    t = rng.permutation(m)[:k]
    s = rng.permutation(m)[:k]
    valid = rng.random(k) < 0.7
    return np.where(valid, t, m), s, valid


# ---------------------------------------------------------------------
# layout: bit-equal to the JAX shards
# ---------------------------------------------------------------------

@pytest.mark.parametrize("rc,shape", LAYOUT_CASES, ids=GRID_IDS)
def test_move_rows_is_bit_equal_to_jax(rc, shape):
    F = _matrix(shape, seed=11)
    t, s, valid = _index_lists(shape[0], 12, seed=12)
    jg, tg = jgrid(*rc), dgrid(*rc)
    jB = _jit(lambda a, t, s, v: jengine.move_rows(a, t, s, v),
              el.from_global(F, el.MC, el.MR, jg), t, s, valid)
    A = et.from_global(F, et.MC, et.MR, tg)
    before = [x.clone() for x in A.local]
    tB = engine.move_rows(A, torch.as_tensor(t), torch.as_tensor(s),
                          torch.as_tensor(valid))
    _assert_tiles_are_shards(tB, _laid_out(jB), jg)
    assert all(torch.equal(x, b) for x, b in zip(A.local, before))


@pytest.mark.parametrize("rc,shape", LAYOUT_CASES, ids=GRID_IDS)
@pytest.mark.parametrize("inverse", [False, True])
def test_permute_rows_storage_is_bit_equal_to_jax(rc, shape, inverse):
    F = _matrix(shape, seed=13)
    p = np.random.default_rng(14).permutation(shape[0])
    jg, tg = jgrid(*rc), dgrid(*rc)
    jB = _jit(lambda a, q: jengine.permute_rows_storage(a, q, inverse),
              el.from_global(F, el.MC, el.MR, jg), p)
    tB = engine.permute_rows_storage(et.from_global(F, et.MC, et.MR, tg),
                                     torch.as_tensor(p), inverse)
    _assert_tiles_are_shards(tB, _laid_out(jB), jg)
    jP = _jit(lambda a, q: el.permute_rows(a, q, inverse),
              el.from_global(F, el.MC, el.MR, jg), p)
    tP = et.permute_rows(et.from_global(F, et.MC, et.MR, tg),
                         torch.as_tensor(p), inverse)
    _assert_tiles_are_shards(tP, _laid_out(jP), jg)


@pytest.mark.parametrize("rc", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("rows,cols", [((0, 23), (0, 11)), ((7, 30), (1, 29))],
                         ids=["prefix", "off-stride"])
def test_interior_view_is_bit_equal_to_jax(rc, rows, cols):
    F = _matrix((37, 29), seed=15)
    jg, tg = jgrid(*rc), dgrid(*rc)
    for dist in (("MC", "MR"), ("VC", "STAR")):
        jA = el.from_global(F, el.Dist[dist[0]], el.Dist[dist[1]], jg)
        tA = et.from_global(F, et.Dist[dist[0]], et.Dist[dist[1]], tg)
        jV = _laid_out(el.interior_view(jA, rows, cols))
        tV = et.interior_view(tA, rows, cols)
        assert tV.gshape == (rows[1] - rows[0], cols[1] - cols[0])
        _assert_tiles_are_shards(tV, jV, jg)
    with pytest.raises(ranks.DeviceGridError):
        et.interior_update(tA, tV, (0, 0))


# ---------------------------------------------------------------------
# the collectives' tally
# ---------------------------------------------------------------------

@pytest.mark.parametrize("rc", [(2, 2), (2, 3), (1, 3)],
                         ids=["2x2", "2x3", "1x3"])
@pytest.mark.parametrize("k", [6, 40])
def test_gather_rows_tally_is_its_closed_form(rc, k):
    """p (r - 1) min(k, local rows) (local width) (itemsize): every rank
    receives r - 1 buffers; k = 40 > 19 local rows offers whole tiles."""
    r, c = rc
    tg = dgrid(r, c)
    A = et.from_global(_matrix((37, 29), seed=16), et.MC, et.MR, tg)
    src = np.random.default_rng(17).integers(0, 37, size=k)
    lr, lc = A.local_shape
    with ranks.tally() as moved:
        got = ranks.gather_rows(A.local, ranks.replicate(
            tg, torch.as_tensor(src)))
    assert moved.bytes == r * c * (r - 1) * min(k, lr) * lc * 8 \
        + (r * c - 1) * k * 8                       # the broadcast
    F = _matrix((37, 29), seed=16)
    for d, rows in enumerate(got):
        mr = d % c
        cols = np.arange(mr, 29, c)
        assert np.array_equal(rows[:, :cols.size].numpy(), F[src][:, cols])


@pytest.mark.parametrize("rc", [(2, 2), (2, 3)], ids=["2x2", "2x3"])
def test_psum_tally_and_bits(rc):
    """Each rank gets its group's sum, every member the same bits, and a
    call moves p (S - 1) x block bytes."""
    r, c = rc
    tg = dgrid(r, c)
    rng = np.random.default_rng(18)
    blocks = [torch.as_tensor(rng.normal(size=(3, 4))) for _ in range(r * c)]
    for axes, S in (("mc", r), ("mr", c), (("mc", "mr"), r * c)):
        with ranks.tally() as moved:
            out = ranks.psum(ranks.Tiles(tg, blocks), axes)
        assert moved.bytes == r * c * (S - 1) * 3 * 4 * 8
        for d in range(r * c):
            members = ranks.group(axes, d, r, c)
            want = blocks[members[0]].clone()
            for s in members[1:]:
                want += blocks[s]
            assert torch.equal(out[d], want)
            assert all(torch.equal(out[d], out[s]) for s in members)


# ---------------------------------------------------------------------
# lu / lu_solve
# ---------------------------------------------------------------------

#: the schedules: look-ahead with the default crossover (the tail is
#: gathered after the first panel at these sizes), without crossover and
#: crossing over after the second panel; the classic order, and crossing
#: over at once
SCHEDULES = [dict(), dict(crossover=0), dict(crossover=8),
             dict(lookahead=False), dict(lookahead=False, crossover=64)]
SCHED_IDS = ["lookahead", "xover0", "xover8", "classic", "classic-xover"]


def _rhs(m, dtype):
    return _matrix((m, NRHS), seed=21, dtype=dtype)


def _ref_grid(rc, shape):
    """The mesh of a classic case's JAX reference: the port's own 2x2 or
    2x3 grid for the square problem, else 2x3 (partial pivoting, the
    replicated classic panel, picks the same rows on every grid), so that
    fewer JAX programs compile.  CALU's references are on the case's own
    mesh: the JAX tournament's near-ties resolve differently on 2x2 and
    2x3 (XLA compiles the sweep per mesh)."""
    return rc if shape[0] == shape[1] and rc == (2, 2) else (2, 3)


def _classic_ref(rc, shape):
    """A classic case's JAX reference (:func:`_ref_grid`); the square one
    on 2x3 also solves, for the ``lu_solve`` tests."""
    rg = _ref_grid(rc, shape)
    return _jax_lu(rg, shape, "float64",
                   solve=(rg, shape) == ((2, 3), (37, 37)))


@shared_cache
def _jax_lu(rc, shape, dtype_name, panel="classic", crossover=None,
            solve=False):
    """The JAX package's factor, permutation and (with ``solve``)
    ``lu_solve_after`` on the ``rc`` mesh, under one ``jax.jit``."""
    dtype = np.dtype(dtype_name).type
    jg = jgrid(*rc)
    jA = el.from_global(_matrix(shape, seed=20, dtype=dtype), el.MC, el.MR,
                        jg)
    jB = el.from_global(_rhs(shape[0], dtype), el.MC, el.MR, jg)
    def f(a, b):
        LU, perm = el.lu(a, nb=NB, panel=panel, crossover=crossover)
        X = el.lu_solve_after(LU, perm, b, nb=NB) if solve else None
        return LU, perm, X
    LU, perm, X = _jit(f, jA, jB)
    return (np.asarray(el.to_global(LU)), np.asarray(perm),
            None if X is None else np.asarray(el.to_global(X)))


def _run_lu(grid, F, **kw):
    A = et.from_global(F, et.MC, et.MR, grid)
    before = [x.clone() for x in ranks.tensors(A)]
    with engine.redist_counts() as counts, engine.redist_trace() as log:
        LU, perm = et.lu(A, nb=NB, **kw)
    assert all(torch.equal(x, b) for x, b in zip(ranks.tensors(A), before))
    return LU, perm, dict(counts), _records(log)


def _check_lu(rc, F, jref, **kw):
    LU, perm, counts, log = _run_lu(dgrid(*rc), F, **kw)
    vLU, vperm, vcounts, vlog = _run_lu(vgrid(*rc), F, **kw)
    assert isinstance(perm, torch.Tensor) and perm.dtype == torch.int64
    assert perm.device == dgrid(*rc).devices[0]
    assert np.array_equal(perm.numpy(), vperm.numpy())
    if jref is not None:
        assert np.array_equal(perm.numpy(), jref[1])
        _close(et.to_global(LU).numpy(), jref[0])
    _close(et.storage_numpy(LU), et.storage_numpy(vLU))
    assert counts == vcounts
    assert log == vlog
    ptrs = [t.data_ptr() for t in LU.local]
    assert len(set(ptrs)) == len(ptrs)
    return LU, perm


@pytest.mark.parametrize("rc", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("sched", SCHEDULES, ids=SCHED_IDS)
def test_lu_matches_jax_and_the_virtual_grid(rc, shape, sched):
    F = _matrix(shape, seed=20)
    _check_lu(rc, F, _classic_ref(rc, shape), **sched)


@pytest.mark.parametrize("rc", [(2, 2), (2, 3)], ids=["2x2", "2x3"])
def test_lu_complex_matches_jax(rc):
    F = _matrix((37, 37), seed=20, dtype=np.complex128)
    jref = _jax_lu((2, 2), (37, 37), "complex128")
    for sched in SCHEDULES:
        _check_lu(rc, F, jref, **sched)


#: the CALU cases also held to JAX: one shape a grid (each reference
#: compiles the tournament anew)
CALU_JAX = {(2, 2): (SHAPES[0],), (2, 3): (SHAPES[2],)}


@pytest.mark.parametrize("rc", [(2, 2), (2, 3)], ids=["2x2", "2x3"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("sched", [dict(crossover=0),
                                   dict(lookahead=False, crossover=0),
                                   dict()],
                         ids=["lookahead", "classic", "xover-first"])
def test_calu_matches_jax_and_the_virtual_grid(rc, shape, sched):
    """CALU's tournament runs on every rank's copy of the panel and its
    row-block solve ends in a psum over 'mc'.  Every case is held to the
    virtual grid, and those of :data:`CALU_JAX` to JAX on the same mesh
    too.  With the crossover at the first step the tail finishes with the
    classic panel (the classic tests hold the tail to JAX)."""
    F = _matrix(shape, seed=20)
    xover = sched.get("crossover")
    jref = _jax_lu(rc, shape, "float64", "calu", xover) \
        if xover == 0 and shape in CALU_JAX[rc] else None
    _check_lu(rc, F, jref, panel="calu", **sched)


@pytest.mark.parametrize("rc", [(2, 2), (2, 3)], ids=["2x2", "2x3"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_calu_bf16_wire_equals_the_virtual_grid(rc, shape):
    F = _matrix(shape, seed=22)
    _check_lu(rc, F, None, panel="calu", crossover=0, comm_precision="bf16")


@pytest.mark.parametrize("rc", GRIDS, ids=GRID_IDS)
def test_lu_solve_and_solve_after_match_jax(rc):
    """Against the JAX solve on the 2x3 mesh (the solution does not
    depend on the grid beyond rounding)."""
    F, Bn = _matrix((37, 37), seed=20), _rhs(37, np.float64)
    jX = _classic_ref((2, 3), (37, 37))[2]
    tg = dgrid(*rc)
    A = et.from_global(F, et.MC, et.MR, tg)
    B = et.from_global(Bn, et.MC, et.MR, tg)
    X = et.lu_solve(A, B, nb=NB)
    assert isinstance(X.local, ranks.Tiles)
    _close(et.to_global(X).numpy(), jX)
    LU, perm = et.lu(A, nb=NB)
    with ranks.tally() as moved:
        X2 = et.lu_solve_after(LU, perm, B, nb=NB)
    _close(et.to_global(X2).numpy(), jX)
    assert np.linalg.norm(F @ et.to_global(X2).numpy() - Bn) \
        < 1e-12 * np.linalg.norm(Bn) * np.linalg.norm(F)
    if rc != (1, 1):
        assert moved.bytes >= (rc[0] * rc[1] - 1) * 37 * 8  # perm's broadcast


def test_timer_ticks_on_a_device_grid_equal_the_virtual_grid():
    from elemental_tpu_torch import obs
    F = _matrix((37, 37), seed=23)
    for kw in (dict(crossover=0), dict(panel="calu", crossover=0)):
        phases = []
        for g in (dgrid(2, 2), vgrid(2, 2)):
            t = obs.PhaseTimer()
            et.lu(et.from_global(F, et.MC, et.MR, g), nb=NB, timer=t, **kw)
            phases.append([(r["phase"], r["step"]) for r in t.records])
        assert phases[0] == phases[1] and phases[0]


# ---------------------------------------------------------------------
# CALU's sweep graphs on a device grid
# ---------------------------------------------------------------------

def test_sweep_pivots_of_two_ranks_on_one_device_are_their_own():
    """Two ranks that share a device and a slab shape get pivot tensors of
    their own (on the card the graph's static output is copied), each
    their own sweep's."""
    rng = np.random.default_rng(24)
    cache = tlu._SweepCache(dgrid(2, 2))
    V1, V2 = (torch.as_tensor(rng.normal(size=(2, 16, 8))) for _ in range(2))
    p1 = tlu._sweep_pivots(V1, 8, cache)
    p2 = tlu._sweep_pivots(V2, 8, cache)
    assert p1.data_ptr() != p2.data_ptr()
    assert torch.equal(p1, tlu._sweep_pivots(V1, 8))
    assert torch.equal(p2, tlu._sweep_pivots(V2, 8))
    assert not torch.equal(p1, p2)


def test_sweep_cache_holds_every_devices_shapes():
    assert tlu._SweepCache(dgrid(2, 2)).limit == tlu._SWEEP_GRAPHS_MAX
    assert tlu._SweepCache(vgrid(2, 2)).limit == tlu._SWEEP_GRAPHS_MAX
    four = types.SimpleNamespace(
        devices=tuple(torch.device("cuda", i) for i in range(4)))
    assert tlu._SweepCache(four).limit == 4 * tlu._SWEEP_GRAPHS_MAX


def test_calu_ranks_hold_their_own_pivots():
    """The per-rank tournaments of one panel give equal permutations in
    tensors of their own."""
    tg = dgrid(2, 2)
    P = et.from_global(_matrix((37, 8), seed=25), et.STAR, et.STAR, tg)
    perms = ranks.per_rank(lambda rk, p: tlu._tournament_pivots(
        p, 8, 2, tlu._SweepCache(tg)), P)
    assert len({t.data_ptr() for t in perms}) == 4
    assert all(torch.equal(perms[0], t) for t in perms)
