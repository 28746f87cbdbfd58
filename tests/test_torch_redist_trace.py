"""The port engine's call counters, trace records, observers and fault
seam against the JAX engine's.

For every legal (src, dst) pair -- no-ops and [CIRC,CIRC] included -- on
1x1, 2x2 and 2x4 grids, under the default and the direct route and each
``comm_precision``, the port's ``redist_counts`` and ``redist_trace``
record (label, path, rounds, wire_bytes, wire_dtype, fallback_reason,
dtype, shapes) equal the JAX engine's.  The JAX side is traced under
``jax.make_jaxpr`` (the records are trace-time metadata), so no
collective runs."""
import functools
from collections import Counter

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.analysis.drivers import storage_shape
from elemental_tpu.core.distmatrix import DistMatrix as JDM
from elemental_tpu.redist import engine as jax_engine
from elemental_tpu_torch.core.distmatrix import DistMatrix as TDM
from elemental_tpu_torch.redist import engine as t_engine

GRIDS = [(1, 1), (2, 2), (2, 4)]
PAIRS = [(a.value, b.value) for a, b in el.LEGAL_PAIRS]
SHAPE = (13, 11)


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _jp(p):
    return el.Dist[p[0]], el.Dist[p[1]]


def _tp(p):
    return et.Dist[p[0]], et.Dist[p[1]]


def _aligns(src, dst, r, c, aligned):
    """Zero alignments, or the largest legal source alignment against a
    shifted destination (MD and CIRC endpoints stay zero-aligned)."""
    if not aligned or "MD" in src + dst or "CIRC" in src + dst:
        return (0, 0), (0, 0)

    def one(pair, big):
        out = []
        for d in pair:
            S = et.core.dist.stride(et.Dist[d], r, c)
            out.append(max(S - 1, 0) if big else min(1, S - 1))
        return tuple(out)
    return one(src, True), one(dst, False)


@functools.cache
def _jax_entries(rc, src, cp, path, aligned, dtype):
    """{dst: (counts, record)} of the JAX engine's redistribute from
    ``src`` to every legal pair, traced in ONE ``jax.make_jaxpr`` (once
    per module): each entry runs in its own counting and recording scope,
    so it counts and records exactly as a trace of it alone does."""
    g = jgrid(*rc)
    shp = storage_shape(*SHAPE, *_jp(src), g)
    spec = jax.ShapeDtypeStruct(shp, dtype)
    out = {}

    def fn(a):
        res = []
        for dst in PAIRS:
            sal, dal = _aligns(src, dst, *rc, aligned)
            A = JDM(a, SHAPE, *_jp(src), *sal, g)
            with jax_engine.redist_counts() as cnt, \
                    jax_engine.redist_trace() as log:
                res.append(jax_engine.redistribute(
                    A, *_jp(dst), *dal, comm_precision=cp, path=path).local)
            out[dst] = (cnt, log[0])
        return res
    jax.make_jaxpr(fn)(spec)
    return out


def _jax_entry(rc, src, dst, cp, path, aligned, dtype=np.float64):
    """(counts, record) of one JAX redistribute entry, traced."""
    return _jax_entries(rc, src, cp, path, aligned, np.dtype(dtype))[dst]


def _port_entry(rc, src, dst, cp, path, aligned, dtype=torch.float64):
    g = tgrid(*rc)
    sal, dal = _aligns(src, dst, *rc, aligned)
    shp = et.core.distmatrix._storage_shape(SHAPE, *_tp(src), g)
    A = TDM(torch.randn(shp, dtype=dtype), SHAPE, *_tp(src), *sal, g)
    with t_engine.redist_counts() as cnt, t_engine.redist_trace() as log:
        B = et.redistribute(A, *_tp(dst), *dal, comm_precision=cp, path=path)
    rec = log[0]
    assert rec.in_id == id(A.local) and rec.out_ids == (id(B.local),)
    assert rec.in_id != rec.out_ids[0]
    return cnt, rec


def _v(x):
    """Dist enums (of either package) as their names, recursively."""
    return tuple(_v(y) for y in x) if isinstance(x, tuple) else x.value


def _fields(rec):
    return (rec.kind, rec.label, _v(rec.src), _v(rec.dst), tuple(rec.gshape),
            str(rec.dtype), tuple(rec.grid_shape), rec.wire_dtype, rec.path,
            rec.rounds, rec.wire_bytes, rec.fallback_reason)


def _counts(cnt):
    return Counter({tuple(tuple(d.value for d in pair) for pair in k)
                    if isinstance(k, tuple) else k: v
                    for k, v in cnt.items()})


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("path", [None, "direct"])
@pytest.mark.parametrize("src", PAIRS, ids=lambda p: f"{p[0]},{p[1]}")
def test_every_pair_records_as_jax(rc, path, src):
    for dst in PAIRS:
        jc, jr = _jax_entry(rc, src, dst, None, path, False)
        tc, tr = _port_entry(rc, src, dst, None, path, False)
        assert _fields(tr) == _fields(jr), (src, dst)
        assert _counts(tc) == _counts(jc), (src, dst)


@pytest.mark.parametrize("rc", [(2, 2), (2, 4)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("src", PAIRS, ids=lambda p: f"{p[0]},{p[1]}")
def test_every_aligned_pair_records_as_jax(rc, src):
    for dst in PAIRS:
        for path in (None, "direct"):
            _, jr = _jax_entry(rc, src, dst, None, path, True)
            _, tr = _port_entry(rc, src, dst, None, path, True)
            assert _fields(tr) == _fields(jr), (src, dst, path)


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("cp", ["bf16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "complex128"])
def test_quantized_wire_records_as_jax(rc, cp, dtype):
    """wire_dtype and the wire bytes of every pair under each mode (int8
    on the gather-to-[STAR,STAR] family and every direct slot, bf16
    elsewhere; nothing on 1x1, replicated sources or complex payloads)."""
    jdt = np.dtype(dtype)
    tdt = getattr(torch, dtype)
    for src in PAIRS:
        for dst in PAIRS:
            for path in (None, "direct"):
                _, jr = _jax_entry(rc, src, dst, cp, path, False, jdt)
                _, tr = _port_entry(rc, src, dst, cp, path, False, tdt)
                assert _fields(tr) == _fields(jr), (src, dst, path)


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("cp", [None, "bf16", "int8"])
def test_panel_spread_counts_and_records_as_jax(rc, cp):
    g, tg = jgrid(*rc), tgrid(*rc)
    shp = storage_shape(12, 4, el.VC, el.STAR, g)

    def fn(a):
        mc, mr = jax_engine.panel_spread(JDM(a, (12, 4), el.VC, el.STAR, 0,
                                             0, g), comm_precision=cp)
        return mc.local, mr.local
    with jax_engine.redist_counts() as jc, jax_engine.redist_trace() as jl:
        jax.make_jaxpr(fn)(jax.ShapeDtypeStruct(shp, np.float32))
    A = TDM(torch.randn(shp), (12, 4), et.VC, et.STAR, 0, 0, tg)
    with t_engine.redist_counts() as tc, t_engine.redist_trace() as tl:
        mc, mr = et.panel_spread(A, comm_precision=cp)
    assert _counts(tc) == _counts(jc) == Counter({"panel_spread": 1})
    assert [_fields(r) for r in tl] == [_fields(r) for r in jl]
    assert tl[0].out_ids == (id(mc.local), id(mr.local))


def test_counts_scoped_and_isolated():
    A = et.from_global(np.eye(8), et.MC, et.MR, tgrid(2, 4))
    with t_engine.redist_counts() as outer:
        et.redistribute(A, et.STAR, et.STAR)
        with t_engine.redist_counts() as inner:
            et.redistribute(A, et.STAR, et.STAR)
            et.redistribute(A, et.MC, et.MR)               # a no-op counts
        assert sum(inner.values()) == 2 and sum(outer.values()) == 1
    assert t_engine.REDIST_COUNTS is not inner
    before = sum(t_engine.REDIST_COUNTS.values())
    et.redistribute(A, et.VC, et.STAR)
    assert sum(t_engine.REDIST_COUNTS.values()) == before + 1


def test_row_moves_count_and_reach_observers_not_the_trace():
    A = et.from_global(np.arange(24.0).reshape(6, 4), et.MC, et.MR,
                       tgrid(2, 2))
    seen = []
    remove = t_engine.add_redist_observer(seen.append)
    try:
        with t_engine.redist_counts() as cnt, t_engine.redist_trace() as log:
            et.move_rows(A, [0, 1], [1, 0], [True, True])
            et.permute_rows_storage(A, torch.arange(5, -1, -1))
    finally:
        remove()
        remove()                                           # idempotent
    assert cnt == Counter({"row_permute": 2}) and log == []
    assert [r.kind for r in seen] == ["row_permute"] * 2
    assert all(r.path == "storage" and r.rounds == 0 for r in seen)
    assert seen[0].wire_bytes == 2 * A.local.shape[1] * 8
    n = len(seen)
    et.redistribute(A, et.STAR, et.STAR)
    assert len(seen) == n                                  # removed


def test_observer_sees_every_public_entry():
    A = et.from_global(np.ones((8, 4)), et.MC, et.MR, tgrid(2, 2))
    seen = []
    remove = t_engine.add_redist_observer(seen.append)
    try:
        B = et.redistribute(A, et.VC, et.STAR)
        et.panel_spread(B)
        et.redistribute(A, et.MC, et.MR)
    finally:
        remove()
    assert [r.label for r in seen] == ["[MC,MR]->[VC,STAR]", "panel_spread",
                                       "[MC,MR]->[MC,MR]"]


class _Flip:
    """A fault-plan stub: negates every output of the chosen targets and
    records the step announcements."""

    def __init__(self, targets):
        self.targets, self.steps, self.calls = targets, [], []

    def apply(self, target, outputs):
        self.calls.append(target)
        if target in self.targets:
            return tuple(-o for o in outputs)
        return outputs

    def set_step(self, step):
        self.steps.append(step)


def test_fault_seam_routes_every_public_output():
    F = np.arange(32.0).reshape(8, 4)
    A = et.from_global(F, et.MC, et.MR, tgrid(2, 2))
    plan = _Flip({"redistribute", "panel_spread", "compute"})
    with t_engine.fault_injection(plan) as inj:
        assert inj is plan
        B = et.redistribute(A, et.VC, et.STAR)
        mc, mr = et.panel_spread(B)
        out, = t_engine.apply_fault("compute", (torch.ones(2),))
        t_engine.set_fault_step(3)
        t_engine.set_fault_step(None)
    assert plan.calls == ["redistribute", "panel_spread", "compute"]
    assert plan.steps == [3, None]
    np.testing.assert_array_equal(et.to_global(B).numpy(), -F)
    np.testing.assert_array_equal(et.to_global(mc).numpy(), F)   # -(-F)
    assert torch.equal(out, -torch.ones(2))
    # outside the block the seam is the identity again
    C = et.redistribute(A, et.VC, et.STAR)
    np.testing.assert_array_equal(et.to_global(C).numpy(), F)
    assert t_engine.apply_fault("compute", (1,)) == (1,)
    t_engine.set_fault_step(5)                               # no injector


def test_fault_seam_reaches_the_drivers_compute_target():
    F = np.random.default_rng(2).normal(size=(8, 8)) + 8 * np.eye(8)
    A = et.from_global(F, et.MC, et.MR, tgrid(2, 2))
    plan = _Flip(set())
    with t_engine.fault_injection(plan):
        et.lu(A, nb=4, panel="calu", crossover=0)
    assert plan.calls.count("compute") == 2                # one a panel
    assert "redistribute" in plan.calls


def test_direct_fallback_reason_on_a_noop():
    A = et.from_global(np.eye(4), et.MC, et.MR, tgrid(2, 2))
    with t_engine.redist_trace() as log:
        B = et.redistribute(A, et.MC, et.MR, path="direct")
    assert log[0].path == "chain" and log[0].fallback_reason == "noop"
    assert log[0].rounds == -1 and B.local is not A.local


def test_bad_and_auto_paths():
    A = et.from_global(np.eye(4), et.MC, et.MR, tgrid(2, 2))
    assert t_engine.REDIST_PATHS == jax_engine.REDIST_PATHS
    with pytest.raises(ValueError, match="path"):
        et.redistribute(A, et.STAR, et.STAR, path="bogus")
    with pytest.raises(ValueError, match="comm_precision"):
        et.redistribute(A, et.STAR, et.STAR, comm_precision="fp8")
    # path='auto' arbitrates as the JAX engine does (same route, same
    # fallback reason); comm_precision='auto' is no wire: ValueError
    jA = el.from_global(np.eye(4), el.MC, el.MR, jgrid(2, 2))
    with t_engine.redist_trace() as tl:
        et.redistribute(A, et.STAR, et.STAR, path="auto")
    with jax_engine.redist_trace() as jl:
        el.redistribute(jA, el.STAR, el.STAR, path="auto")
    assert (tl[0].path, tl[0].fallback_reason) == \
        (jl[0].path, jl[0].fallback_reason)
    with pytest.raises(ValueError, match="comm_precision"):
        et.panel_spread(et.redistribute(A, et.VC, et.STAR),
                        comm_precision="auto")


@pytest.mark.parametrize("src,dst", [
    (("MC", "MR"), ("MR", "MC")), (("MC", "MR"), ("STAR", "STAR")),
    (("VC", "STAR"), ("MR", "STAR")), (("STAR", "VR"), ("MC", "MR"))],
    ids=lambda p: f"{p[0]},{p[1]}")
@pytest.mark.parametrize("rc", [(2, 2), (2, 4), (4, 2), (3, 2)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_chain_metadata_equals_jax(rc, src, dst):
    for gshape in ((13, 11), (64, 48), (1, 7)):
        for sz in (1, 2, 4, 8):
            assert t_engine.chain_cost(_tp(src), _tp(dst), gshape, rc, sz) == \
                jax_engine.chain_cost(_jp(src), _jp(dst), gshape, rc, sz)
    for a in PAIRS:
        for b in PAIRS:
            if "CIRC" in a + b:
                continue
            js = jax_engine._chain_steps(_jp(a), _jp(b), *rc)
            ts = t_engine._chain_steps(_tp(a), _tp(b), *rc)
            assert [(k, S, tuple(d.value for d in p)) for k, S, p in ts] == \
                [(k, S, tuple(d.value for d in p)) for k, S, p in js]


@pytest.mark.parametrize("src,dst", [
    (("MC", "STAR"), ("MC", "MR")), (("STAR", "MR"), ("MC", "MR")),
    (("MR", "STAR"), ("MR", "MC")), (("STAR", "MC"), ("MR", "MC")),
    (("STAR", "STAR"), ("MC", "MR")), (("STAR", "STAR"), ("STAR", "STAR")),
    (("STAR", "STAR"), ("VC", "STAR"))], ids=lambda p: f"{p[0]},{p[1]}")
def test_contract_sums_the_partials_as_jax(src, dst):
    """The JAX test's setting: every rank holds partial = F / (number of
    ranks sharing its block); the sum lands on [cdist,rdist]."""
    rc = (2, 4)
    r, c = rc
    F = np.random.default_rng(8).normal(size=(9, 10))
    g = tgrid(*rc)
    share = {"MC": c, "MR": r, "STAR": 1}
    k = (share[src[0]] if src[1] == "STAR" else 1) * \
        (share[src[1]] if src[0] == "STAR" else 1)
    if src == ("STAR", "STAR"):
        k = r * c
    A = et.from_global(F / k, *_tp(src), g)
    parts = A.local.expand(r * c, *A.local.shape).clone()
    B = et.contract(A.with_local(parts), *_tp(dst))
    assert B.dist == _tp(dst)
    np.testing.assert_allclose(et.to_global(B).numpy(), F, rtol=1e-12)
    ref = el.from_global(F, *_jp(dst), jgrid(*rc))
    np.testing.assert_allclose(et.storage_numpy(B), np.asarray(ref.local),
                               rtol=1e-12, atol=1e-15)


def test_contract_rejects_other_pairs():
    A = et.from_global(np.eye(4), et.VC, et.STAR, tgrid(2, 2))
    with pytest.raises(NotImplementedError, match="contract"):
        et.contract(A.with_local(A.local.expand(4, *A.local.shape)), et.MC,
                    et.MR)
