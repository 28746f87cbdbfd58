"""The redist_path knob and the engine's ``path='auto'`` (the twin of
``tests/tune/test_redist_path_knob.py``): registry rules, the one-shot
plans' cost terms, the arbitration of every legal pair against the JAX
engine's (with and without recorded constants), the ``redist_fallbacks``
counter, and ``collective_sites`` against the collectives of the JAX
engine's jaxpr."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.analysis.drivers import storage_shape
from elemental_tpu.analysis.jaxpr_walk import collect_events
from elemental_tpu.obs import metrics as j_metrics
from elemental_tpu.redist import engine as j_engine
from elemental_tpu.tune import cache as jcache
from elemental_tpu_torch.obs import metrics as t_metrics
from elemental_tpu_torch.redist import engine as t_engine
from elemental_tpu_torch.tune import cache as tcache
from elemental_tpu_torch.tune import cost_model
from elemental_tpu_torch.tune.knobs import (OPS, REDIST_PATHS, TuneContext,
                                            candidate_configs)

PAIRS = sorted(el.LEGAL_PAIRS, key=str)
TD = {d.name: d for d in et.Dist}


def _tp(pair):
    return (TD[pair[0].name], TD[pair[1].name])


@functools.cache
def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


@pytest.fixture
def caches(tmp_path, monkeypatch):
    monkeypatch.setenv(jcache.ENV_DIR, str(tmp_path / "jax"))
    monkeypatch.setenv(tcache.ENV_DIR, str(tmp_path / "torch"))
    jcache.clear_redist_constants_memo()
    tcache.clear_redist_constants_memo()
    yield
    jcache.clear_redist_constants_memo()
    tcache.clear_redist_constants_memo()


def _ctx(op, dims, grid_shape):
    return TuneContext(op=op, dims=dims, dtype="float32",
                       grid_shape=grid_shape, backend="cpu")


def test_knob_registered_on_all_six_drivers_and_in_sync():
    for op in ("cholesky", "lu", "gemm", "qr", "trsm", "herk"):
        assert "redist_path" in OPS[op].knobs, op
    assert REDIST_PATHS == (None, "direct")
    assert set(REDIST_PATHS) <= set(t_engine.REDIST_PATHS)
    assert t_engine.REDIST_PATHS == j_engine.REDIST_PATHS


def test_candidates_dead_on_1x1_full_on_2x2():
    for op in ("cholesky", "qr", "trsm", "herk"):
        assert {c.get("redist_path") for c in candidate_configs(
            _ctx(op, (64, 64), (1, 1)))} == {None}
        assert {c.get("redist_path") for c in candidate_configs(
            _ctx(op, (64, 64), (2, 2)))} == set(REDIST_PATHS)
    ctx = _ctx("lu", (64, 64), (2, 2))
    pinned = candidate_configs(ctx, {"redist_path": "direct"})
    assert {c["redist_path"] for c in pinned} == {"direct"}
    assert len(pinned) == len(candidate_configs(ctx, {"redist_path": None}))


def test_gemm_cost_model_swaps_gather_sites_for_one_shot_plans():
    ctx = _ctx("gemm", (512, 512, 512), (2, 2))
    base, direct = (cost_model.score_config(
        "gemm", {"alg": "C", "nb": 128, "comm_precision": None,
                 "redist_path": rp}, ctx=ctx) for rp in (None, "direct"))
    assert base.prim_counts == {"all_gather": 8}
    assert direct.prim_counts == {"all_to_all": 8}
    assert direct.rounds == base.rounds


def test_traced_drivers_price_the_one_shot_schedule():
    cases = {"qr": {"nb": 16, "panel": "classic"}, "trsm": {"nb": 16},
             "herk": {"nb": 16},
             "lu": {"nb": 16, "lookahead": True, "crossover": 0,
                    "panel": "classic"}}
    out = {}
    for op, cfg in cases.items():
        ctx = _ctx(op, (64, 64), (2, 2))
        out[op] = [cost_model.score_config(
            op, dict(cfg, comm_precision=None, redist_path=rp), ctx=ctx)
            for rp in (None, "direct")]
        assert out[op][1].rounds <= out[op][0].rounds, op
        assert out[op][1].prim_counts != out[op][0].prim_counts, op
    base, direct = out["herk"]
    assert direct.rounds < base.rounds
    assert direct.prim_counts.get("all_gather", 0) == 0
    base, direct = out["lu"]
    assert direct.prim_counts.get("all_gather", 0) == 0
    assert direct.prim_counts["all_to_all"] > base.prim_counts["all_to_all"]


def _routes(shape, rc):
    """(port, JAX) (path, fallback_reason, rounds) of path='auto' for
    every legal pair on an r x c grid (the JAX engine traced under
    make_jaxpr: no collective runs)."""
    m, n = shape
    g = et.Grid(*rc, device="cpu")
    F = np.arange(m * n, dtype=np.float32).reshape(m, n)
    port, jax_ = [], []
    for src in PAIRS:
        A = et.redistribute(et.from_global(F, et.MC, et.MR, g), *_tp(src))
        for dst in PAIRS:
            with t_engine.redist_trace() as tl:
                B = et.redistribute(A, *_tp(dst), path="auto")
            np.testing.assert_array_equal(et.to_global(B).numpy(), F)
            port.append((tl[0].path, tl[0].fallback_reason, tl[0].rounds))

            def f(a, src=src, dst=dst):
                Aj = el.DistMatrix(a, (m, n), src[0], src[1], 0, 0,
                                   jgrid(*rc))
                return el.redistribute(Aj, *dst, path="auto").local
            sh = storage_shape(m, n, src[0], src[1], jgrid(*rc))
            with j_engine.redist_trace() as jl:
                jax.make_jaxpr(f)(jax.ShapeDtypeStruct(sh, jnp.float32))
            jax_.append((jl[0].path, jl[0].fallback_reason, jl[0].rounds))
    return port, jax_


def test_auto_arbitration_equals_the_jax_engine_on_every_pair(caches):
    port, jax_ = _routes((13, 9), (2, 2))
    assert len(port) == 196 and port == jax_
    assert {p[1] for p in port} >= {"noop", "arbitration"}


def test_auto_arbitration_follows_recorded_constants(caches):
    """With a latency-bound record for the grid (JAX: the CPU backend,
    the port: its CPU grid) both engines flip the same pairs to direct."""
    for save in (jcache.save_redist_constants, tcache.save_redist_constants):
        save((2, 2), "cpu", alpha_s=1.0, bw_bytes_per_s=1e10)
    port, jax_ = _routes((13, 9), (2, 2))
    assert port == jax_
    assert sum(p[0] == "direct" for p in port) > 0


def test_fallbacks_are_counted_as_the_jax_engine_counts_them():
    rng = np.random.default_rng(0)
    F = rng.normal(size=(12, 8)).astype(np.float32)
    A = et.from_global(F, et.MC, et.MR, et.Grid(2, 2, device="cpu"))
    jA = el.from_global(F, el.MC, el.MR, jgrid(2, 2))
    calls = [((et.MC, et.MR), (el.MC, el.MR), "direct"),       # noop
             ((et.MC, et.MR), (el.MC, el.MR), "auto"),         # noop
             ((et.STAR, et.STAR), (el.STAR, el.STAR), "auto"),
             ((et.VC, et.STAR), (el.VC, el.STAR), "auto"),
             ((et.MR, et.MC), (el.MR, el.MC), "direct"),
             ((et.STAR, et.MR), (el.STAR, el.MR), "auto")]
    with t_metrics.scoped() as treg, j_metrics.scoped() as jreg:
        for tdst, jdst, path in calls:
            et.redistribute(A, *tdst, path=path)
            el.redistribute(jA, *jdst, path=path)
        for reason in ("noop", "no_plan", "arbitration"):
            assert treg.counter_value("redist_fallbacks", reason=reason) == \
                jreg.counter_value("redist_fallbacks", reason=reason), reason
        assert treg.counter_value("redist_fallbacks", reason="noop") == 2


@pytest.mark.parametrize("shape,path,cp", [
    ((13, 9), None, None), ((13, 9), "direct", None),
    ((13, 9), None, "int8"),
    ((64, 48), None, "bf16"), ((64, 48), "direct", "int8")],
    ids=lambda v: str(v))
def test_collective_sites_equal_the_jax_jaxpr(shape, path, cp):
    """For every legal pair on 2x2, the sites the port names are the
    collectives the JAX engine's traced ``redistribute`` holds: the same
    primitives, participants and ring-model bytes."""
    m, n = shape
    g = jgrid(2, 2)
    for src in PAIRS:
        for dst in PAIRS:
            def f(a, src=src, dst=dst):
                Aj = el.DistMatrix(a, (m, n), src[0], src[1], 0, 0, g)
                return el.redistribute(Aj, *dst, path=path,
                                       comm_precision=cp).local
            sh = storage_shape(m, n, src[0], src[1], g)
            evs = collect_events(jax.make_jaxpr(f)(
                jax.ShapeDtypeStruct(sh, jnp.float32)))
            want = sorted((e.prim, e.axis_size, e.bytes_per_call * e.count)
                          for e in evs)
            got = sorted((s.prim, s.axis_size, s.bytes)
                         for s in t_engine.collective_sites(
                             _tp(src), _tp(dst), (m, n), (2, 2), 4,
                             path=path, comm_precision=cp))
            assert got == want, (src, dst)


def test_collective_sites_of_misaligned_pairs_and_an_odd_grid():
    """Nonzero alignments (a rotation before or after the hops) and a 3x2
    grid, against the jaxpr."""
    checked = 0
    for rc, aligns in (((2, 2), ((1, 1), (0, 0))), ((2, 2), ((0, 0), (1, 0))),
                       ((3, 2), ((0, 0), (0, 0))), ((3, 2), ((2, 1), (1, 0)))):
        g = jgrid(*rc)
        m, n = 11, 7
        for src in PAIRS:
            for dst in PAIRS:
                if el.CIRC in src + dst or (
                        el.MD in src + dst and aligns != ((0, 0), (0, 0))):
                    continue

                def f(a, src=src, dst=dst):
                    Aj = el.DistMatrix(a, (m, n), src[0], src[1],
                                       *aligns[0], g)
                    return el.redistribute(Aj, *dst, *aligns[1]).local
                sh = storage_shape(m, n, src[0], src[1], g)
                try:
                    jx = jax.make_jaxpr(f)(jax.ShapeDtypeStruct(sh,
                                                                jnp.float32))
                except ValueError:
                    continue
                want = sorted((e.prim, e.axis_size, e.bytes_per_call)
                              for e in collect_events(jx))
                got = sorted((s.prim, s.axis_size, s.bytes)
                             for s in t_engine.collective_sites(
                                 _tp(src), _tp(dst), (m, n), rc, 4,
                                 aligns=aligns))
                assert got == want, (rc, aligns, src, dst)
                checked += 1
    assert checked > 400
