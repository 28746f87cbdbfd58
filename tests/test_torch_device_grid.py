"""The device grid: an r x c grid whose ranks each hold their own block on
their own device (here ``Grid(r, c, devices=["cpu"] * (r * c))``).

Held against the JAX package on the same mesh (``el.Grid(jax.devices()[:
r * c], height=r)``) on 1x1, 2x2, 2x3 and 1x3 grids at odd sizes:
``from_global``, the redistributions of the ``hpd_solve`` path,
``panel_spread`` and ``transpose_dist`` give tiles bit-equal to the JAX
shards, rank by rank; ``cholesky`` (look-ahead, classic, crossover at the
first step and never), ``hpd_solve`` and ``cholesky_solve_after`` in both
``uplo`` s agree with JAX to 1e-12 relative (float64, complex128) and with
the port's virtual grid of the same shape to 1e-12, and record the same
redistribution counts and records.  The byte tally of the collectives is
the records' ring-model bytes on every rank, and the drivers and knobs
that do not run there yet refuse a device grid with ``DeviceGridError``
(``tests/test_torch_device_grid_lu.py`` and ``_qr.py`` hold the LU and
QR drivers that do)."""
import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu_torch.core import ranks
from elemental_tpu_torch.redist import engine
from .torch_shared_ref import shared_cache

GRIDS = [(1, 1), (2, 2), (2, 3), (1, 3)]
GRID_IDS = [f"{r}x{c}" for r, c in GRIDS]
SHAPES = [(11, 9), (37, 29)]

#: the redistributions of the hpd_solve path: cholesky's diagonal block,
#: panel and write-backs ('L'), the 'U' form's transpose pair, and the
#: triangular sweeps' right-hand-side and off-panel moves
PATH_MOVES = [
    (("MC", "MR"), ("STAR", "STAR")), (("MC", "MR"), ("VC", "STAR")),
    (("STAR", "STAR"), ("MC", "MR")), (("MC", "STAR"), ("MC", "MR")),
    (("MR", "MC"), ("MC", "MR")), (("MC", "MR"), ("STAR", "VR")),
    (("STAR", "VR"), ("STAR", "MR")), (("STAR", "MR"), ("MC", "MR")),
    (("MC", "MR"), ("MC", "STAR")), (("MC", "MR"), ("STAR", "MC")),
]
MOVE_IDS = [f"{a[0]}{a[1]}-{b[0]}{b[1]}" for a, b in PATH_MOVES]


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def dgrid(r, c):
    return et.Grid(r, c, devices=["cpu"] * (r * c))


def vgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _pair(mod, names):
    return mod.Dist[names[0]], mod.Dist[names[1]]


def _matrix(shape, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=shape)
    if np.issubdtype(dtype, np.complexfloating):
        F = F + 1j * rng.normal(size=shape)
    return F.astype(dtype)


def _jax_shards(jA, jg) -> dict:
    """{(mc, mr): the JAX shard on mesh device (mc, mr)}."""
    by_dev = {s.device: np.asarray(s.data) for s in jA.local.addressable_shards}
    r, c = jg.height, jg.width
    return {(i, j): by_dev[jg.mesh.devices[i, j]]
            for i in range(r) for j in range(c)}


def _assert_tiles_are_shards(tA, jA, jg):
    g = tA.grid
    shards = _jax_shards(jA, jg)
    for (mc, mr), want in shards.items():
        d = mc * g.width + mr
        tile = tA.local[d]
        assert tile.device == g.devices[d]
        assert tile.shape == tA.local_shape
        assert np.array_equal(tile.numpy(), want), (mc, mr)
    assert np.array_equal(et.storage_numpy(tA), np.asarray(jA.local))


@pytest.mark.parametrize("rc", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dist", [("MC", "MR"), ("VC", "STAR"),
                                  ("STAR", "VR"), ("MD", "STAR")],
                         ids=lambda d: f"{d[0]}{d[1]}")
def test_from_global_tiles_are_the_jax_shards(rc, shape, dist):
    F = _matrix(shape, seed=1)
    jg, tg = jgrid(*rc), dgrid(*rc)
    jA = el.from_global(F, *_pair(el, dist), jg)
    tA = et.from_global(F, *_pair(et, dist), tg)
    _assert_tiles_are_shards(tA, jA, jg)
    assert np.array_equal(et.to_global(tA).numpy(), F)
    back = et.from_storage(np.asarray(jA.local), shape, *_pair(et, dist),
                           grid=tg)
    _assert_tiles_are_shards(back, jA, jg)


@pytest.mark.parametrize("rc", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("src,dst", PATH_MOVES, ids=MOVE_IDS)
def test_path_redistribution_is_bit_equal_to_jax(rc, shape, src, dst):
    F = _matrix(shape, seed=2)
    jg, tg = jgrid(*rc), dgrid(*rc)
    jB = el.redistribute(el.from_global(F, *_pair(el, src), jg),
                         *_pair(el, dst))
    tB = et.redistribute(et.from_global(F, *_pair(et, src), tg),
                         *_pair(et, dst))
    assert (tB.cdist.value, tB.rdist.value) == dst
    _assert_tiles_are_shards(tB, jB, jg)


@pytest.mark.parametrize("rc", GRIDS, ids=GRID_IDS)
def test_every_legal_pair_and_alignment_equals_the_virtual_grid(rc):
    """Every legal pair to every legal pair (and, off MD / CIRC, nonzero
    alignments at either end) on the device grid gives the virtual grid's
    storage, bit for bit."""
    F = _matrix((11, 9), seed=3)
    vg, tg = vgrid(*rc), dgrid(*rc)
    for s in et.LEGAL_PAIRS:
        for d in et.LEGAL_PAIRS:
            plain = et.MD not in s + d and et.CIRC not in s + d
            for a_src, a_dst in ([((0, 0), (0, 0)), ((1, 0), (0, 2)),
                                  ((0, 1), (1, 1))] if plain
                                 else [((0, 0), (0, 0))]):
                want = et.redistribute(et.from_global(F, *s, vg, *a_src),
                                       *d, *a_dst)
                got = et.redistribute(et.from_global(F, *s, tg, *a_src),
                                      *d, *a_dst)
                assert np.array_equal(et.storage_numpy(got),
                                      et.storage_numpy(want)), (s, d, a_src,
                                                                a_dst)


@pytest.mark.parametrize("rc", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("conj", [False, True])
def test_panel_spread_and_transpose_dist_are_bit_equal_to_jax(rc, shape,
                                                               conj):
    F = _matrix(shape, seed=4, dtype=np.complex128)
    jg, tg = jgrid(*rc), dgrid(*rc)
    jA = el.from_global(F, el.VC, el.STAR, jg)
    tA = et.from_global(F, et.VC, et.STAR, tg)
    jmc, jmr = el.panel_spread(jA, conj=conj)
    tmc, tmr = et.panel_spread(tA, conj=conj)
    _assert_tiles_are_shards(tmc, jmc, jg)
    _assert_tiles_are_shards(tmr, jmr, jg)
    jM = el.from_global(F, el.MC, el.MR, jg)
    tM = et.from_global(F, et.MC, et.MR, tg)
    tT = et.transpose_dist(tM, conj=conj)
    assert tT.dist == (et.MR, et.MC) and tT.gshape == shape[::-1]
    _assert_tiles_are_shards(tT, el.transpose_dist(jM, conj=conj), jg)


@pytest.mark.parametrize("rc", [(2, 2), (2, 3)], ids=["2x2", "2x3"])
def test_bf16_wire_equals_the_virtual_grid(rc):
    F = _matrix((37, 29), seed=5)
    for src, dst in PATH_MOVES[:2]:
        got = et.redistribute(et.from_global(F, *_pair(et, src), dgrid(*rc)),
                              *_pair(et, dst), comm_precision="bf16")
        want = et.redistribute(et.from_global(F, *_pair(et, src), vgrid(*rc)),
                               *_pair(et, dst), comm_precision="bf16")
        assert np.array_equal(et.storage_numpy(got), et.storage_numpy(want))
    P = et.from_global(F[:, :6], et.VC, et.STAR, dgrid(*rc))
    Pv = et.from_global(F[:, :6], et.VC, et.STAR, vgrid(*rc))
    for got, want in zip(et.panel_spread(P, comm_precision="bf16"),
                         et.panel_spread(Pv, comm_precision="bf16")):
        assert np.array_equal(et.storage_numpy(got), et.storage_numpy(want))


@pytest.mark.parametrize("dist", [("MC", "MR"), ("STAR", "STAR")],
                         ids=["MCMR", "STARSTAR"])
def test_tiles_do_not_alias(dist):
    """Each rank's tile is a tensor of its own: writing one leaves the
    others (replicated copies included) unchanged, and the matrix a
    redistribution read is untouched by it."""
    F = _matrix((11, 9), seed=6)
    tA = et.from_global(F, *_pair(et, dist), dgrid(2, 2))
    before = [t.clone() for t in tA.local]
    tA.local[0].fill_(7.0)
    for t, b in zip(tA.local.tiles[1:], before[1:]):
        assert torch.equal(t, b)
    tM = et.from_global(F, et.MC, et.MR, dgrid(2, 2))
    m0 = [t.clone() for t in tM.local]
    tB = et.redistribute(tM, et.STAR, et.STAR)
    tB.local[3].fill_(-1.0)
    assert [torch.equal(tB.local[d], tB.local[0]) for d in range(4)] \
        == [True, True, True, False]
    assert all(torch.equal(t, b) for t, b in zip(tM.local, m0))


def test_grid_layout_and_identity():
    devs = ["cpu"] * 6
    g = et.Grid(devices=devs)
    assert (g.height, g.width) == (2, 3)
    assert g.devices == tuple(torch.device("cpu") for _ in devs)
    assert g == et.Grid(2, 3, devices=devs) != et.Grid(3, 2, devices=devs)
    assert g != et.Grid(2, 3, device="cpu")
    assert len({g, et.Grid(2, 3, devices=devs)}) == 1
    assert et.Grid(1, 3, device="cpu").devices is None
    assert engine.backend_of(g) == "cpu"
    with pytest.raises(ValueError):
        et.Grid(4, devices=devs)
    with pytest.raises(ValueError):
        et.Grid(2, 2, device="cpu", devices=["cpu"] * 4)
    if torch.cuda.device_count() < 8:
        with pytest.raises(RuntimeError, match="cuda"):
            et.Grid(2, 4, devices=[f"cuda:{i}" for i in range(8)])


# ---------------------------------------------------------------------
# cholesky / hpd_solve
# ---------------------------------------------------------------------

N, NRHS, NB = 37, 5, 8
#: the schedules: look-ahead with the default crossover (the tail is
#: gathered after the first panel at this size), look-ahead without
#: crossover, classic, and classic crossing over at once
SCHEDULES = [dict(), dict(crossover=0), dict(lookahead=False),
             dict(lookahead=False, crossover=N)]
SCHED_IDS = ["lookahead", "lookahead-xover0", "classic", "classic-xover"]


def _hpd(dtype, seed=7):
    G = _matrix((N, N), seed=seed, dtype=dtype)
    return G @ G.conj().T / N + N * np.eye(N)


def _rhs(dtype):
    return _matrix((N, NRHS), seed=8, dtype=dtype)


@shared_cache
def _jax_solve(rc, dtype_name, uplo):
    """The JAX package's factor and solve on the same mesh, default
    schedule (every schedule gives the same factor to rounding), under
    one ``jax.jit``."""
    dtype = np.dtype(dtype_name).type
    jg = jgrid(*rc)
    jA = el.from_global(_hpd(dtype), el.MC, el.MR, jg)
    jB = el.from_global(_rhs(dtype), el.MC, el.MR, jg)
    def solve(a, b):
        L = el.cholesky(a, uplo, nb=NB)
        return L, el.cholesky_solve_after(L, b, uplo, nb=NB)
    # one program: eagerly every step of the loop compiles alone
    jL, jX = jax.jit(solve)(jA, jB)
    return np.asarray(el.to_global(jL)), np.asarray(el.to_global(jX))


def _close(got, want, rtol=1e-12):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _records(log) -> list:
    return [(r.kind, r.src, r.dst, r.gshape, r.dtype, r.grid_shape,
             r.wire_dtype, r.path, r.rounds, r.wire_bytes, r.fallback_reason,
             r.aligns) for r in log]


def _run(grid, dtype, uplo, sched):
    A = et.from_global(_hpd(dtype), et.MC, et.MR, grid)
    B = et.from_global(_rhs(dtype), et.MC, et.MR, grid)
    with engine.redist_counts() as counts, engine.redist_trace() as log:
        L = et.cholesky(A, uplo, nb=NB, **sched)
        X = et.cholesky_solve_after(L, B, uplo, nb=NB)
    return L, X, dict(counts), _records(log)


@pytest.mark.parametrize("rc", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["float64", "complex128"])
@pytest.mark.parametrize("sched", SCHEDULES, ids=SCHED_IDS)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_cholesky_and_solve_match_jax_and_the_virtual_grid(rc, dtype, sched,
                                                           uplo):
    L, X, counts, log = _run(dgrid(*rc), dtype, uplo, sched)
    vL, vX, vcounts, vlog = _run(vgrid(*rc), dtype, uplo, sched)
    jL, jX = _jax_solve(rc, np.dtype(dtype).name, uplo)
    got_L, got_X = et.to_global(L).numpy(), et.to_global(X).numpy()
    _close(got_L, jL)
    _close(got_X, jX)
    _close(et.storage_numpy(L), et.storage_numpy(vL))
    _close(et.storage_numpy(X), et.storage_numpy(vX))
    assert counts == vcounts
    assert log == vlog


@pytest.mark.parametrize("rc", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_hpd_solve_on_a_device_grid(rc, uplo):
    tg = dgrid(*rc)
    F, Bn = _hpd(np.float64), _rhs(np.float64)
    X = et.hpd_solve(et.from_global(F, et.MC, et.MR, tg),
                     et.from_global(Bn, et.MC, et.MR, tg), uplo=uplo, nb=NB)
    assert X.grid == tg and isinstance(X.local, ranks.Tiles)
    got = et.to_global(X).numpy()
    _close(got, _jax_solve(rc, "float64", uplo)[1])
    assert np.linalg.norm(F @ got - Bn) < 1e-12 * np.linalg.norm(Bn)


def test_timer_ticks_read_every_rank():
    """A phase timer on a device grid ticks the same phases as on the
    virtual grid (each tick waits for every device of the grid)."""
    from elemental_tpu_torch import obs
    phases = []
    for g in (dgrid(2, 2), vgrid(2, 2)):
        t = obs.PhaseTimer()
        et.cholesky(et.from_global(_hpd(np.float64), et.MC, et.MR, g),
                    nb=NB, crossover=0, timer=t)
        phases.append([(r["phase"], r["step"]) for r in t.records])
    assert phases[0] == phases[1] and phases[0]


# ---------------------------------------------------------------------
# what the collectives move
# ---------------------------------------------------------------------

@pytest.mark.parametrize("rc", [(1, 1), (2, 2), (2, 3)],
                         ids=["1x1", "2x2", "2x3"])
@pytest.mark.parametrize("src,dst", PATH_MOVES, ids=MOVE_IDS)
def test_tally_is_the_records_wire_bytes_on_every_rank(rc, src, dst):
    """At a shape every grid divides, the bytes the collectives copy
    between ranks are p times the record's ring-model bytes (per rank),
    for every move without a permutation; a ppermute keeps the blocks
    that stay on their rank, so there the tally is at most that."""
    r, c = rc
    tA = et.from_global(_matrix((12, 24), seed=9), *_pair(et, src),
                        dgrid(r, c))
    with ranks.tally() as moved, engine.redist_trace() as log:
        et.redistribute(tA, *_pair(et, dst))
    (rec,) = log
    kinds = {k for k, _, _ in engine._chain_steps(rec.src, rec.dst, r, c)}
    if "ppermute" in kinds:
        assert 0 < moved.bytes <= r * c * rec.wire_bytes
    else:
        assert moved.bytes == r * c * rec.wire_bytes


# ---------------------------------------------------------------------
# what does not run on a device grid yet
# ---------------------------------------------------------------------

@pytest.mark.parametrize("driver", ["qr_tsqr", "tsqr", "lu_abft",
                                    "lu_solve_info", "svd", "herm_eig",
                                    "gemm"])
def test_drivers_outside_the_slice_refuse_a_device_grid(driver):
    tg = dgrid(2, 2)
    A = et.from_global(_hpd(np.float64), et.MC, et.MR, tg)
    B = et.from_global(_rhs(np.float64), et.MC, et.MR, tg)
    call = {"qr_tsqr": lambda: et.qr(A, nb=NB, panel="tsqr"),
            "tsqr": lambda: et.tsqr(et.redistribute(A, et.VC, et.STAR)),
            "lu_abft": lambda: et.lu(A, nb=NB, abft=True),
            "lu_solve_info": lambda: et.lu_solve(A, B, nb=NB, info=True),
            "svd": lambda: et.svd(A),
            "herm_eig": lambda: et.herm_eig(A),
            "gemm": lambda: et.gemm(A, B)}[driver]
    with pytest.raises(ranks.DeviceGridError, match="device grid"):
        call()


def test_knobs_outside_the_slice_raise():
    tg = dgrid(2, 2)
    A = et.from_global(_hpd(np.float64), et.MC, et.MR, tg)
    with pytest.raises(ValueError, match="int8"):
        et.redistribute(A, et.STAR, et.STAR, comm_precision="int8")
    with pytest.raises(ValueError, match="direct"):
        et.redistribute(A, et.VC, et.STAR, path="direct")
    with pytest.raises(ranks.DeviceGridError):
        et.cholesky(A, nb="auto")
    with pytest.raises(ranks.DeviceGridError):
        et.cholesky(A, nb=NB, abft=True)
    with pytest.raises(ranks.DeviceGridError):
        et.cholesky(A, nb=NB, health=True)
    with pytest.raises(ranks.DeviceGridError):
        et.lu(A, nb="auto")
    with pytest.raises(ranks.DeviceGridError):
        et.qr(A, nb=NB, health=True)
    with pytest.raises(TypeError):
        A.local[:2]
