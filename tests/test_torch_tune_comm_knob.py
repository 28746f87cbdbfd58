"""The comm_precision knob in the port's tuner (the twin of
``tests/tune/test_comm_knob.py``): registry coverage, candidate rules,
'auto' resolution and the bytes-vs-decode cost term."""
import numpy as np
import pytest

import elemental_tpu_torch as et
from elemental_tpu_torch.tune import cost_model
from elemental_tpu_torch.tune.knobs import (COMM_PRECISIONS, OPS,
                                            TuneContext, candidate_configs)


@pytest.fixture(autouse=True)
def empty_cache(tmp_path, monkeypatch):
    from elemental_tpu_torch.tune import cache as tc, policy as tp
    monkeypatch.setenv(tc.ENV_DIR, str(tmp_path))
    tp.clear_memo()
    yield
    tp.clear_memo()


def _grid(r, c):
    return et.Grid(r, c, device="cpu")


def _ctx(op, dims, grid_shape):
    return TuneContext(op=op, dims=dims, dtype="float32",
                       grid_shape=grid_shape, backend="cpu")


def test_every_op_registers_the_knob_and_the_words_match_the_engine():
    from elemental_tpu_torch.redist.quantize import COMM_PRECISIONS as Q
    from elemental_tpu.tune import knobs as jk
    assert COMM_PRECISIONS == Q == jk.COMM_PRECISIONS
    for op, spec in OPS.items():
        assert "comm_precision" in spec.knobs, op
        assert spec.knobs == jk.OPS[op].knobs, op


def test_candidates_dead_on_1x1_full_on_2x2():
    c1 = candidate_configs(_ctx("cholesky", (64, 64), (1, 1)))
    assert {c["comm_precision"] for c in c1} == {None}
    c2 = candidate_configs(_ctx("cholesky", (64, 64), (2, 2)))
    assert {c["comm_precision"] for c in c2} == set(COMM_PRECISIONS)


def test_pinned_value_freezes_the_dimension():
    ctx = _ctx("lu", (64, 64), (2, 2))
    cands = candidate_configs(ctx, {"comm_precision": "bf16"})
    assert {c["comm_precision"] for c in cands} == {"bf16"}
    assert len(cands) == len(candidate_configs(ctx, {"comm_precision": None}))


def test_auto_resolves_none_on_1x1_and_quantized_when_bandwidth_bound():
    kn = et.tune.resolve_knobs("cholesky", gshape=(64, 64),
                               dtype=np.float32, grid=_grid(1, 1),
                               knobs={"nb": 16, "lookahead": True,
                                      "crossover": 0,
                                      "comm_precision": "auto"})
    assert kn["comm_precision"] is None
    kn = et.tune.resolve_knobs("cholesky", gshape=(4096, 4096),
                               dtype=np.float32, grid=_grid(2, 2),
                               knobs={"nb": 256, "lookahead": True,
                                      "crossover": 0,
                                      "comm_precision": "auto"})
    assert kn["comm_precision"] in ("bf16", "int8")


def test_explicit_none_always_wins():
    kn = et.tune.resolve_knobs("cholesky", gshape=(2048, 2048),
                               dtype=np.float32, grid=_grid(2, 2),
                               knobs={"nb": "auto", "lookahead": "auto",
                                      "crossover": "auto",
                                      "comm_precision": None})
    assert kn["comm_precision"] is None and isinstance(kn["nb"], int)


@pytest.mark.parametrize("mode", sorted(cost_model.WIRE_FACTORS))
def test_cost_model_wire_term(mode):
    ctx = _ctx("gemm", (512, 512, 512), (2, 2))
    base = cost_model.score_config("gemm", {"alg": "C", "nb": 128,
                                            "comm_precision": None}, ctx=ctx)
    quant = cost_model.score_config("gemm", {"alg": "C", "nb": 128,
                                             "comm_precision": mode}, ctx=ctx)
    assert quant.comm_bytes == pytest.approx(0.5 * base.comm_bytes)
    assert quant.bandwidth_s < base.bandwidth_s
    assert quant.decode_s > 0 and base.decode_s == 0.0
    assert quant.rounds == base.rounds


def test_traced_driver_wire_term_orthogonal():
    ctx = _ctx("cholesky", (64, 64), (2, 2))
    outs = {m: cost_model.score_config(
        "cholesky", {"nb": 16, "lookahead": True, "crossover": 0,
                     "comm_precision": m}, ctx=ctx) for m in COMM_PRECISIONS}
    assert outs["bf16"].prim_counts == outs[None].prim_counts
    assert outs["bf16"].rounds == outs[None].rounds
    assert outs["bf16"].comm_bytes == pytest.approx(
        cost_model.WIRE_FACTORS["bf16"] * outs[None].comm_bytes)
    assert outs["int8"].comm_bytes < outs["bf16"].comm_bytes
    assert outs["int8"].decode_s > outs["bf16"].decode_s


def test_the_engine_refuses_auto_as_a_wire():
    """Only the drivers resolve comm_precision='auto'; the engine's
    entries take wires, and 'auto' is none (ValueError, as the JAX
    engine's check_comm_precision)."""
    A = et.from_global(np.eye(8), et.MC, et.MR, _grid(2, 2))
    with pytest.raises(ValueError, match="comm_precision"):
        et.redistribute(A, et.STAR, et.STAR, comm_precision="auto")
    L = et.cholesky(et.from_global(np.eye(8) * 4, et.MC, et.MR, _grid(2, 2)),
                    nb=4, comm_precision="auto")
    np.testing.assert_allclose(et.to_global(L).numpy(), 2 * np.eye(8))
