"""The port's comm plans (``elemental_tpu_torch.analysis``) against the JAX
package's live traces.

For every registered driver on 1x1 and 2x2 CPU grids, the port runs the
driver once and builds its ``comm_plan/v1`` document from the engine's
records; the JAX package traces the same driver under
``jax.make_jaxpr``.  The reference is the JAX package's live trace
(memoized once per module), not the golden file: where a golden
disagrees with the live trace, that is a finding of the JAX package.
The rest mirrors ``tests/analysis/``: the look-ahead, CALU, quantized
wire and one-shot inequalities, the slicing gemm's ratios and the
walker's event fields, in record form."""
import functools

import numpy as np
import pytest
import torch

import elemental_tpu_torch as et
from elemental_tpu import analysis as jan
from elemental_tpu_torch import analysis as an
from elemental_tpu_torch.analysis.drivers import gemm_slice_extents
from elemental_tpu_torch.redist.engine import redistribute
from .torch_analysis_common import jax_trace

GRIDS = [(1, 1), (2, 2)]
NAMES = an.driver_names()
MC, MR, VC, STAR = et.MC, et.MR, et.VC, et.STAR


def _jax_plan(name, rc):
    return jax_trace(name, rc)[0]


@functools.cache
def _port(name, rc):
    return an.trace_driver(name, et.Grid(*rc, device="cpu"))


def _plan(name, rc):
    return _port(name, rc)[0]


def _rounds(plan):
    return sum(t["count"] for t in plan.totals().values())


def _bytes(plan):
    return sum(t["bytes"] for t in plan.totals().values())


def test_registry_is_the_jax_registry():
    assert NAMES == jan.driver_names() and len(NAMES) == 33
    for k in ("DEFAULT_N", "DEFAULT_NB", "DEFAULT_XOVER", "MEM_BUDGET_FACTORS",
              "LOOKAHEAD_PAIRS", "CALU_PAIRS", "COMMQ_PAIRS",
              "COMMQ_MIN_BYTE_RATIO", "DIRECT_PAIRS", "SCHEMA",
              "COLLECTIVE_PRIMS", "MEM_SCHEMA"):
        assert getattr(an, k) == getattr(jan, k), k
    for name in NAMES:
        t, j = an.DRIVERS[name], jan.DRIVERS[name]
        assert (t.allow_bf16, t.mem_budget_factor) == \
            (j.allow_bf16, j.mem_budget_factor), name
    assert gemm_slice_extents(64) == \
        jan.drivers.gemm_slice_extents(64)


def test_public_names_cover_the_jax_package():
    """Every JAX ``analysis.__all__`` name is in the port's, or mapped to
    its record counterpart in ``RENAMED``."""
    for name in jan.__all__:
        twin = an.RENAMED.get(name, name)
        assert twin in an.__all__ and hasattr(an, twin), name
    assert set(an.RENAMED) <= set(jan.__all__) - set(an.__all__)


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_comm_plan_equals_the_live_jax_trace(name, rc):
    """Meta, ``static``, totals, every site row (prim, axes, axis_size,
    shape, dtype, count, bytes) and ``redistributes``."""
    want = jan.golden_doc(_jax_plan(name, rc))
    got = an.golden_doc(_plan(name, rc))
    assert an.diff_docs(want, got) == []
    assert got == want
    assert got["static"] is True


@pytest.mark.parametrize("la,classic", an.LOOKAHEAD_PAIRS)
def test_lookahead_strictly_fewer_all_gathers(la, classic):
    p_la, p_cl = _plan(la, (2, 2)), _plan(classic, (2, 2))
    assert p_la.count("all_gather") < p_cl.count("all_gather")
    assert _rounds(p_la) < _rounds(p_cl)


@pytest.mark.parametrize("calu,baselines", an.CALU_PAIRS,
                         ids=[c for c, _ in an.CALU_PAIRS])
def test_calu_strictly_fewer_rounds_per_panel(calu, baselines):
    p_ca = _plan(calu, (2, 2))
    for base in baselines:
        assert _rounds(p_ca) < _rounds(_plan(base, (2, 2))), base
    assert p_ca.count("all_gather") < _plan("lu_crossover",
                                            (2, 2)).count("all_gather")
    assert p_ca.count("all_to_all") == 0 and p_ca.count("psum") > 0


def test_tsqr_adds_no_collective_rounds():
    assert _rounds(_plan("qr_tsqr", (2, 2))) == _rounds(_plan("qr", (2, 2)))


@pytest.mark.parametrize("commq,base", an.COMMQ_PAIRS)
def test_commq_byte_drop_at_identical_rounds(commq, base):
    pq, pb = _plan(commq, (2, 2)), _plan(base, (2, 2))
    assert {k: v["count"] for k, v in pq.totals().items()} == \
        {k: v["count"] for k, v in pb.totals().items()}
    assert pq.redistributes == pb.redistributes
    assert _bytes(pq) > 0
    assert _bytes(pb) / _bytes(pq) >= an.COMMQ_MIN_BYTE_RATIO
    assert pq.events and all(ev.dtype == "bfloat16" for ev in pq.events)
    # a 1x1 grid has no wire: the knob changes nothing
    assert _plan(commq, (1, 1)).totals() == _plan(base, (1, 1)).totals()


@pytest.mark.parametrize("direct,chain", an.DIRECT_PAIRS)
def test_direct_strictly_fewer_rounds_on_2x2(direct, chain):
    assert _rounds(_plan(direct, (2, 2))) < _rounds(_plan(chain, (2, 2)))
    assert _rounds(_plan(direct, (1, 1))) <= _rounds(_plan(chain, (1, 1)))
    assert "all_gather" not in _plan(direct, (2, 2)).totals()


def test_redist_md_direct_ragged_byte_drop():
    assert 0 < _bytes(_plan("redist_md_direct", (2, 2))) \
        < _bytes(_plan("redist_md", (2, 2)))


def _gemm_plan(alg, rc=(2, 2)):
    m, k, n = gemm_slice_extents(an.DEFAULT_N)
    g = et.Grid(*rc, device="cpu")
    rng = np.random.default_rng(0)
    A = et.from_global(torch.from_numpy(rng.normal(size=(m, k))), MC, MR, g)
    B = et.from_global(torch.from_numpy(rng.normal(size=(k, n))), MC, MR, g)
    return an.trace_callable(
        lambda a, b: et.gemm(a, b, alg=alg, nb=an.DEFAULT_NB), (A, B),
        name=f"gemm_{alg}", grid=g)[0]


def _psums(alg, rc):
    """The schedule's contraction psums (GSPMD's on the JAX side, out of
    a trace's scope), from the port's closed-form cost model."""
    from elemental_tpu_torch.tune import TuneContext, cost_model
    ctx = TuneContext("gemm", gemm_slice_extents(an.DEFAULT_N), "float32",
                      rc, "cpu")
    b = cost_model.score_config("gemm", {"alg": alg, "nb": an.DEFAULT_NB},
                                ctx=ctx)
    return b.prim_counts.get("psum", 0)


@pytest.mark.parametrize("rc", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_slice_gemm_ratios_against_its_twins(rc):
    """The tall-skinny slicing gemm: three one-shot rounds and no hidden
    psum, strictly fewer rounds than every stationary / dot twin (with
    its psums), and >= 1.5x fewer wire bytes than stationary C."""
    s = _gemm_plan("slice", rc)
    assert _rounds(s) == 3 and _psums("slice", rc) == 0
    for alg in ("C", "A", "B", "dot", "gspmd"):
        assert _rounds(s) < _rounds(_gemm_plan(alg, rc)) + _psums(alg, rc), \
            alg
    assert _bytes(_gemm_plan("C", rc)) >= 1.5 * _bytes(s)


def test_registered_plans_are_static_and_lint_clean():
    for name in NAMES:
        for rc in GRIDS:
            plan, records, _ = _port(name, rc)
            assert plan.static, name
            assert an.lint_plan(plan, records) == [], (name, rc)


def test_record_calls_agree_with_the_redistributes_map():
    plan, records, _ = _port("cholesky_lookahead", (2, 2))
    assert an.count_record_calls(records, "panel_spread") == \
        plan.redistributes["panel_spread"]
    assert sum(plan.redistributes.values()) == len(records)


# ---------------------------------------------------------------------
# events, in record form (tests/analysis/test_jaxpr_walk.py)
# ---------------------------------------------------------------------

def _g22():
    return et.Grid(2, 2, device="cpu")


def _mat(n=16, dtype=torch.float32):
    return et.from_global(torch.arange(n * n, dtype=dtype).reshape(n, n),
                          MC, MR, _g22())


def test_star_star_gather_event_fields():
    """A fused [MC,MR] -> [STAR,STAR] gather on 2x2: one all_gather over
    ('mc', 'mr'), four participants, the (8, 8) per-rank block."""
    plan, records, _ = an.trace_callable(
        lambda a: redistribute(a, STAR, STAR), (_mat(),), grid=_g22())
    (ev,) = plan.events
    assert ev.prim == "all_gather" and ev.axes == ("mc", "mr")
    assert ev.axis_size == 4 and ev.shape == (8, 8)
    assert ev.dtype == "float32" and ev.count == 1 and ev.static
    assert not ev.conditional
    assert ev.bytes_per_call == an.estimate_bytes("all_gather", 8 * 8 * 4, 4)
    assert ev.path == ("[MC,MR]->[STAR,STAR]#0", "hop[0]")


def test_calu_psum_is_noted_with_its_axes():
    plan, _, notes = _port("lu_calu", (2, 2))
    assert [s.prim for s in notes] == ["psum", "psum"]
    psums = [ev for ev in plan.events if ev.prim == "psum"]
    assert psums and all(ev.axes == ("mc",) and ev.axis_size == 2
                         for ev in psums)
    assert all(ev.path[0].startswith("driver:psum#") for ev in psums)


def test_bf16_wire_prices_the_wire_dtype():
    plan, _, _ = an.trace_callable(
        lambda a: redistribute(a, STAR, STAR, comm_precision="bf16"),
        (_mat(),), grid=_g22())
    (ev,) = plan.events
    assert ev.dtype == "bfloat16"
    assert ev.bytes_per_call == an.estimate_bytes("all_gather", 8 * 8 * 2, 4)


def test_size_one_grid_issues_no_event():
    g = et.Grid(1, 1, device="cpu")
    A = et.from_global(torch.ones(8, 8), MC, MR, g)
    plan, records, _ = an.trace_callable(
        lambda a: redistribute(a, STAR, STAR), (A,), grid=g)
    assert len(records) == 1 and plan.events == []


def test_estimate_bytes_formulas():
    nb = 1000
    assert an.estimate_bytes("all_gather", nb, 4) == 3000
    assert an.estimate_bytes("reduce_scatter", nb, 4) == 750
    assert an.estimate_bytes("psum", nb, 4) == 1500
    assert an.estimate_bytes("all_to_all", nb, 4) == 750
    assert an.estimate_bytes("ppermute", nb, 4) == nb
    assert an.estimate_bytes("all_gather", nb, 1) == 0
    for prim in an.COLLECTIVE_PRIMS:
        assert an.estimate_bytes(prim, nb, 4) == \
            jan.estimate_bytes(prim, nb, 4)


def test_loop_invariant_collective_found():
    """The same unchanged operand gathered twice: the repeat is found."""
    def fn(a):
        for _ in range(3):
            redistribute(a, STAR, STAR)
    _, records, _ = an.trace_callable(fn, (_mat(),), grid=_g22())
    found = an.find_loop_invariant_collectives(records)
    assert [f[0] for f in found] == ["[MC,MR]->[STAR,STAR]"] * 2
    assert [f[1] for f in found] == [(0, 1), (1, 2)]


def test_loop_variant_collective_not_flagged():
    """The operand changes in place between the gathers (its version
    moves): not hoistable."""
    def fn(a):
        for _ in range(3):
            redistribute(a, STAR, STAR)
            a.local.mul_(2.0)
    _, records, _ = an.trace_callable(fn, (_mat(),), grid=_g22())
    assert an.find_loop_invariant_collectives(records) == []


def test_panel_impl_override_leaves_the_meta_alone():
    with an.panel_impl_override("torch"):
        doc = an.golden_doc(an.trace_driver(
            "lu_crossover", et.Grid(2, 2, device="cpu"))[0])
    assert doc == an.golden_doc(_plan("lu_crossover", (2, 2)))
    assert an.drivers._PANEL_IMPL_OVERRIDE is None
