"""The one-shot plans: the port's copy of the plan compiler gives plans
equal to the JAX package's ``compile_plan`` field by field, and
``redistribute(..., path='direct')`` -- which carries out the plan's own
gather / scatter index maps on the stacked storage -- gives storage
bit-equal to the JAX package's for every pair and alignment that
``tests/core/test_redist_direct.py`` covers (the JAX direct route is
bit-equal to its chain, and both to the layout of ``from_global``, which
is the reference storage here)."""
import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.redist import plan as jplan
from elemental_tpu_torch.redist import plan as tplan
from elemental_tpu_torch.redist import engine as t_engine

PAIRS = [(a.value, b.value) for a, b in el.LEGAL_PAIRS]
PLAN_GRIDS = [(1, 1), (2, 2), (2, 4), (4, 2), (3, 2), (1, 4)]


def _jp(p):
    return el.Dist[p[0]], el.Dist[p[1]]


def _tp(p):
    return et.Dist[p[0]], et.Dist[p[1]]


def f(m, n):
    i = np.arange(m)[:, None]
    j = np.arange(n)[None, :]
    return (i * 997.0 + j + 1).astype(np.float64)


def _aligned_case(src, dst, r, c):
    """The JAX test's alignments: the largest per source dim against a
    shifted destination; MD and CIRC endpoints zero-aligned."""
    if "MD" in src + dst:
        return (0, 0), (0, 0)

    def one(pair, big):
        out = []
        for d in pair:
            S = 1 if d == "CIRC" else et.core.dist.stride(et.Dist[d], r, c)
            out.append(max(S - 1, 0) if big else min(1, S - 1))
        return tuple(out)
    return one(src, True), one(dst, False)


def _plan_fields(p):
    if p is None:
        return None
    return (tuple(d.value for d in p.src), tuple(d.value for d in p.dst),
            p.gshape, p.grid_shape, p.kind, p.comm_axes, p.perm, p.slot_shape,
            p.send_rows.tolist(), p.send_cols.tolist(), p.recv_rows.tolist(),
            p.recv_cols.tolist(), p.src_local, p.dst_local, p.groups,
            p.rounds, p.wire_bytes(4), p.nslots, p.describe())


@pytest.mark.parametrize("rc", PLAN_GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("aligned", [False, True], ids=["zero", "aligned"])
def test_compiled_plans_equal_jax(rc, aligned):
    for gshape in ((13, 9), (19, 11), (1, 5)):
        for src in PAIRS:
            for dst in PAIRS:
                sal, dal = _aligned_case(src, dst, *rc) if aligned \
                    else ((0, 0), (0, 0))
                tp = tplan.compile_plan(_tp(src), _tp(dst), gshape, rc, sal,
                                        dal)
                jp = jplan.compile_plan(_jp(src), _jp(dst), gshape, rc, sal,
                                        dal)
                assert _plan_fields(tp) == _plan_fields(jp), (src, dst)
                assert tplan.comm_axes_for(_tp(src), _tp(dst), *rc, sal,
                                           dal) == \
                    jplan.comm_axes_for(_jp(src), _jp(dst), *rc, sal, dal)


@pytest.mark.parametrize("rc", [(2, 2), (2, 4), (4, 1), (1, 4)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_slice_plans_equal_jax(rc):
    for m, k, n in ((2048, 64, 16), (16, 64, 2048), (40, 24, 40)):
        tm, tps = tplan.gemm_slice_plans(m, k, n, rc)
        jm, jps = jplan.gemm_slice_plans(m, k, n, rc)
        assert tm == jm and [t for t, _ in tps] == [t for t, _ in jps]
        assert [_plan_fields(p) for _, p in tps] == \
            [_plan_fields(p) for _, p in jps]
        assert tplan.slice_row_mode(m, n, rc) == jplan.slice_row_mode(m, n, rc)
    for rows, cols in (((0, 8), None), ((4, 12), (2, 9)), (None, (6, 11))):
        a = tplan.compile_slice_plan(_tp(("MC", "MR")), _tp(("VC", "STAR")),
                                     (13, 11), rc, rows, cols)
        b = jplan.compile_slice_plan(_jp(("MC", "MR")), _jp(("VC", "STAR")),
                                     (13, 11), rc, rows, cols)
        assert _plan_fields(a) == _plan_fields(b)


def _check_direct(rc, src, dst, F, aligned):
    r, c = rc
    sal, dal = _aligned_case(src, dst, r, c) if aligned else ((0, 0), (0, 0))
    tg = et.Grid(r, c, device="cpu")
    jg = el.Grid(jax.devices()[: r * c], height=r)
    A = et.from_global(F, *_tp(src), tg, *sal)
    with t_engine.redist_trace() as log:
        B = et.redistribute(A, *_tp(dst), *dal, path="direct")
    assert B.dist == _tp(dst) and (B.calign, B.ralign) == \
        ((0, 0) if dst[0] == "CIRC" else dal)
    want = el.from_global(F, *_jp(dst), jg, *dal)
    assert np.array_equal(et.storage_numpy(B), np.asarray(want.local)), \
        (src, dst)
    assert np.array_equal(et.to_global(B).numpy(), F)
    noop = src == dst and sal == dal
    assert log[0].path == ("chain" if noop else "direct")


@pytest.mark.parametrize("rc", [(1, 1), (2, 2), (2, 4)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("src", PAIRS, ids=lambda p: f"{p[0]},{p[1]}")
def test_direct_storage_bit_equal_to_jax(rc, src):
    F = f(19, 11) if rc == (2, 4) else f(13, 9)
    for dst in PAIRS:
        _check_direct(rc, src, dst, F, aligned=False)


@pytest.mark.parametrize("rc", [(1, 1), (2, 2), (2, 4)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("src", PAIRS, ids=lambda p: f"{p[0]},{p[1]}")
def test_aligned_direct_storage_bit_equal_to_jax(rc, src):
    F = f(19, 11) if rc == (2, 4) else f(13, 9)
    for dst in PAIRS:
        _check_direct(rc, src, dst, F, aligned=True)


@pytest.mark.parametrize("src,dst", [
    (("MC", "MR"), ("STAR", "VC")), (("MR", "MC"), ("MC", "MR")),
    (("MD", "STAR"), ("STAR", "MD")), (("VC", "STAR"), ("VR", "STAR"))],
    ids=lambda p: f"{p[0]},{p[1]}")
def test_direct_equals_chain_on_ragged_extents(src, dst):
    for m, n in ((1, 1), (7, 3), (33, 17)):
        F = f(m, n)
        for rc in ((2, 4), (4, 2), (3, 2)):
            A = et.from_global(F, *_tp(src), et.Grid(*rc, device="cpu"))
            Bc = et.redistribute(A, *_tp(dst), path="chain")
            Bd = et.redistribute(A, *_tp(dst), path="direct")
            assert torch_equal(Bc.local, Bd.local), (rc, m, n)


def torch_equal(a, b):
    return a.shape == b.shape and bool((a == b).all())


def test_direct_plan_for_is_the_compiled_plan():
    A = et.from_global(f(13, 9), et.MC, et.MR, et.Grid(2, 4, device="cpu"))
    p = t_engine.direct_plan_for(A, et.STAR, et.VC)
    assert _plan_fields(p) == _plan_fields(
        tplan.compile_plan(A.dist, (et.STAR, et.VC), (13, 9), (2, 4)))
    assert t_engine.direct_plan_for(A, et.MC, et.MR) is None


@pytest.mark.parametrize("rc", [(2, 2), (2, 4)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_gemm_slice_rides_the_direct_plans(rc):
    """``gemm(alg='slice')`` moves its slices through the one-shot plans;
    the product is F @ G to 1e-12."""
    rng = np.random.default_rng(3)
    F, G = rng.normal(size=(40, 8)), rng.normal(size=(8, 6))
    tg = et.Grid(*rc, device="cpu")
    A, B = (et.from_global(X, et.MC, et.MR, tg) for X in (F, G))
    with t_engine.redist_trace() as log:
        C = et.gemm(A, B, alg="slice")
    assert [r.path for r in log] == ["direct"] * 3
    np.testing.assert_allclose(et.to_global(C).numpy(), F @ G, rtol=1e-12)
