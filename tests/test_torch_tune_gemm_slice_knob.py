"""'slice' in the port's gemm alg space (the twin of
``tests/tune/test_gemm_slice_knob.py``): the cost model picks 'slice'
exactly where its one-shot plans win and keeps every other winner; the
picks equal the JAX package's."""
import math

import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu_torch.tune import cost_model as cm
from elemental_tpu_torch.tune.knobs import (DOT_ELEMENT_CAP, GEMM_ALGS,
                                            TuneContext, _gemm_space)


@pytest.fixture(autouse=True)
def empty_cache(tmp_path, monkeypatch):
    from elemental_tpu.tune import cache as jc, policy as jp
    from elemental_tpu_torch.tune import cache as tc, policy as tp
    monkeypatch.setenv(jc.ENV_DIR, str(tmp_path / "jax"))
    monkeypatch.setenv(tc.ENV_DIR, str(tmp_path / "torch"))
    jp._RESOLVE_MEMO.clear()
    tp.clear_memo()
    yield
    jp._RESOLVE_MEMO.clear()
    tp.clear_memo()


def _pick(gshape, shape, **extra):
    knobs = {"alg": "auto", "nb": None, "comm_precision": None,
             "redist_path": None, **extra}
    kn = et.tune.resolve_knobs("gemm", gshape=gshape, dtype=np.float32,
                               grid=et.Grid(*shape, device="cpu"),
                               knobs=knobs)
    return kn["alg"]


def _jpick(gshape, shape):
    grid = el.Grid(jax.devices()[: shape[0] * shape[1]], height=shape[0])
    return el.tune.resolve_knobs(
        "gemm", gshape=gshape, dtype=np.float32, grid=grid,
        knobs={"alg": "auto", "nb": None, "comm_precision": None,
               "redist_path": None})["alg"]


def test_slice_registered_last():
    assert GEMM_ALGS == ("dot", "C", "A", "B", "gspmd", "slice")


@pytest.mark.parametrize("gshape,shape,want", [
    ((8192, 512, 256), (2, 4), "slice"),
    ((8192, 512, 256), (2, 2), "slice"),
    ((65536, 512, 512), (2, 4), "slice"),
    ((256, 256, 256), (1, 1), "dot"),
    ((8192, 512, 256), (1, 1), "dot"),
    ((65536, 512, 512), (1, 1), "dot"),
    ((256, 256, 256), (2, 2), "gspmd"),
    ((4096, 4096, 4096), (2, 2), "gspmd"),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_auto_picks(gshape, shape, want):
    assert _pick(gshape, shape) == want
    if shape[0] * shape[1] <= 4:
        assert _jpick(gshape, shape) == want


def test_slice_priced_identically_across_redist_path():
    ctx = TuneContext("gemm", (8192, 512, 256), "float32", (2, 4), "cpu")
    s = [cm.score_config("gemm", {"alg": "slice", "nb": None,
                                  "redist_path": rp}, ctx=ctx)
         for rp in (None, "direct")]
    assert s[0].total_s == s[1].total_s and s[0].comm_bytes == s[1].comm_bytes


def test_slice_nb_collapsed():
    ctx = TuneContext("gemm", (1024, 256, 128), "float32", (2, 2), "cpu")
    space = _gemm_space(ctx, {})
    assert len({c.get("nb") for c in space if c["alg"] == "slice"}) == 1
    assert len({c.get("nb") for c in space if c["alg"] == "C"}) > 1


def test_slice_replicated_operand_memory_guard():
    k = n = 1 << 12
    m = 1 << 20
    assert k * n > DOT_ELEMENT_CAP
    ctx = TuneContext("gemm", (m, k, n), "float32", (2, 4), "cpu")
    assert not [c for c in _gemm_space(ctx, {}) if c["alg"] == "slice"]
    assert [c for c in _gemm_space(ctx, {"alg": "slice"})
            if c["alg"] == "slice"]
    ok = TuneContext("gemm", (m, 512, 512), "float32", (2, 4), "cpu")
    assert [c for c in _gemm_space(ok, {}) if c["alg"] == "slice"]


def test_slice_zero_comm_on_1x1_candidates():
    ctx = TuneContext("gemm", (2048, 64, 16), "float32", (1, 1), "cpu")
    b = cm.score_config("gemm", {"alg": "slice", "nb": None}, ctx=ctx)
    assert b.rounds == 0 and b.comm_bytes == 0
    assert math.isfinite(b.total_s) and b.compute_s > 0


def test_slice_pick_drives_the_port_gemm():
    """The tall-skinny 2x2 pick runs the port's slicing gemm: the product
    is right."""
    rng = np.random.default_rng(3)
    A, B = rng.normal(size=(96, 16)), rng.normal(size=(16, 8))
    g = et.Grid(2, 2, device="cpu")
    C = et.gemm(et.from_global(A, et.MC, et.MR, g),
                et.from_global(B, et.MC, et.MR, g))
    np.testing.assert_allclose(et.to_global(C).numpy(), A @ B, atol=1e-12)
