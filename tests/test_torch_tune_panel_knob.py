"""The panel and panel_impl knobs in the port's tuner (the twin of
``tests/tune/test_panel_knob.py``): the panel strategies' pivot-chain
term and 'auto' ranking, and the panel-implementation term -- 'kernel'
is native on the card ('gpu'), so every op resolves there to the
hand-written kernels for a real dtype, while 'cpu' keeps the JAX
package's choice ('torch' / 'xla')."""
import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu_torch.tune import cost_model as cm
from elemental_tpu_torch.tune.knobs import (LU_PANELS, OPS, PANEL_IMPLS,
                                            QR_PANELS, TuneContext,
                                            candidate_configs)


@pytest.fixture(autouse=True)
def empty_cache(tmp_path, monkeypatch):
    from elemental_tpu_torch.tune import cache as tc, policy as tp
    monkeypatch.setenv(tc.ENV_DIR, str(tmp_path))
    tp.clear_memo()
    yield
    tp.clear_memo()


def _grid(r, c, device="cpu"):
    return et.Grid(r, c, device=device)


def _ctx(op, grid_shape, n=64, backend="cpu", dtype="float32"):
    return TuneContext(op, (n, n), dtype, grid_shape, backend)


def test_panel_words_follow_the_kernels_module():
    from elemental_tpu_torch.kernels import PANEL_IMPLS as K
    assert PANEL_IMPLS == K == ("torch", "kernel")
    assert {"panel", "panel_impl"} <= set(OPS["lu"].knobs)
    assert {"panel", "panel_impl"} <= set(OPS["qr"].knobs)
    assert "panel_impl" in OPS["cholesky"].knobs


def test_lu_space_has_panel_dimension():
    assert {c["panel"] for c in candidate_configs(_ctx("lu", (2, 2)))} \
        == set(LU_PANELS)
    assert {c["panel"] for c in candidate_configs(_ctx("qr", (2, 2)))} \
        == set(QR_PANELS)


def test_single_row_grids_enumerate_classic_only():
    for gs in [(1, 1), (1, 8)]:
        for op in ("lu", "qr"):
            assert {c["panel"] for c in candidate_configs(_ctx(op, gs))} \
                == {"classic"}
    pinned = candidate_configs(_ctx("lu", (1, 1)), {"panel": "calu"})
    assert all(c["panel"] == "calu" for c in pinned)


def test_complex_dtypes_enumerate_the_plain_panel_only():
    cands = candidate_configs(_ctx("cholesky", (1, 1), dtype="complex64"))
    assert {c["panel_impl"] for c in cands} == {"torch"}


def _score(op, shape, panel, n=64, nb=16):
    cfg = {"nb": nb, "panel": panel}
    if op == "lu":
        cfg.update(lookahead=True, crossover=0)
    return cm.score_config(op, cfg, ctx=_ctx(op, shape, n))


def test_pivot_term_prefers_the_tree_panels_on_multi_row_grids():
    calu, classic = _score("lu", (2, 2), "calu"), _score("lu", (2, 2),
                                                          "classic")
    assert calu.pivot_s < classic.pivot_s and calu.total_s < classic.total_s
    assert calu.rounds < classic.rounds
    tsqr, qc = _score("qr", (2, 2), "tsqr"), _score("qr", (2, 2), "classic")
    assert tsqr.pivot_s < qc.pivot_s and tsqr.total_s < qc.total_s
    one = _score("lu", (1, 1), "calu"), _score("lu", (1, 1), "classic")
    assert one[0].pivot_s == one[1].pivot_s


def test_auto_picks_the_tree_panel_on_multi_row_grids():
    for op, tree in (("lu", "calu"), ("qr", "tsqr")):
        res = et.tune.resolve(op, gshape=(64, 64), dtype=np.float32,
                              grid=_grid(2, 2), requested={"panel": "auto"})
        assert res.source == "cost_model" and res.config["panel"] == tree
        for shape in ((1, 1), (1, 8)):
            res1 = et.tune.resolve(op, gshape=(64, 64), dtype=np.float32,
                                   grid=_grid(*shape),
                                   requested={"panel": "auto"})
            assert res1.config["panel"] == "classic"


def test_lu_driver_accepts_panel_auto():
    rng = np.random.default_rng(80)
    F = rng.normal(size=(24, 24))
    g = _grid(2, 2)
    LU, perm = et.lu(et.from_global(F, et.MC, et.MR, g), nb=8, panel="auto")
    lu_ = et.to_global(LU).numpy()
    L, U = np.tril(lu_, -1) + np.eye(24), np.triu(lu_)
    np.testing.assert_allclose(L @ U, F[perm.numpy()], atol=1e-12)


@pytest.mark.parametrize("op", ["cholesky", "lu", "qr"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_cuda_grid_resolves_the_kernel(op, shape):
    """On a CUDA grid ('gpu') panel_impl='auto' resolves to 'kernel' for
    a real dtype -- 'torch' there would take the plain panel, ~100x the
    kernel's time -- and to 'torch' for a complex dtype; on the CPU it
    stays 'torch', the JAX package's 'xla'.  No card is needed: the
    cost model runs on the CPU."""
    defaults = {"cholesky": {"lookahead": True, "crossover": None},
                "lu": {"lookahead": True, "crossover": None,
                       "panel": "classic"},
                "qr": {"panel": "classic"}}[op]
    for n in (64, 32768):
        res = et.tune.resolve(op, gshape=(n, n), dtype=torch.float32,
                              grid=_grid(*shape, "cuda"),
                              requested={**defaults, "nb": "auto",
                                         "panel_impl": "auto",
                                         "comm_precision": None,
                                         "redist_path": None})
        assert res.config["panel_impl"] == "kernel", (op, n)
    cres = et.tune.resolve(op, gshape=(64, 64), dtype=torch.complex64,
                           grid=_grid(*shape, "cuda"),
                           requested={"panel_impl": "auto"})
    assert cres.config["panel_impl"] == "torch"
    req = {**defaults, "nb": None, "panel_impl": "auto",
           "comm_precision": None, "redist_path": None}
    jres = el.tune.resolve(op, gshape=(64, 64), dtype=np.float32,
                           grid=el.Grid(jax.devices()[: shape[0] * shape[1]],
                                        height=shape[0]), requested=req)
    tres = et.tune.resolve(op, gshape=(64, 64), dtype=torch.float32,
                           grid=_grid(*shape), requested=req)
    assert (jres.config["panel_impl"], tres.config["panel_impl"]) == \
        ("xla", "torch")


def test_the_panel_launch_term():
    """'kernel' pays one launch per nb-panel on 'gpu' and the penalty
    elsewhere; 'torch' one unit per column of the sweep."""
    lat = cm.machine_for("gpu").latency_s
    cfg = {"nb": 2048, "lookahead": True, "crossover": 4096}
    g = TuneContext("cholesky", (32768, 32768), "float32", (1, 1), "gpu")
    kern = cm._panel_impl_seconds("cholesky", g, {**cfg,
                                                  "panel_impl": "kernel"},
                                  cm.machine_for("gpu"))
    plain = cm._panel_impl_seconds("cholesky", g, {**cfg,
                                                   "panel_impl": "torch"},
                                   cm.machine_for("gpu"))
    assert kern == pytest.approx(16 * lat) and plain == pytest.approx(
        32768 * lat)
    c = TuneContext("cholesky", (32768, 32768), "float32", (1, 1), "cpu")
    assert cm._panel_impl_seconds(
        "cholesky", c, {**cfg, "panel_impl": "kernel"},
        cm.machine_for("cpu")) == pytest.approx(
        32768 * cm.machine_for("cpu").latency_s * cm.INTERPRET_PENALTY)


def test_a_resolved_word_reaches_the_panel_plan():
    """The drivers hand resolve_panel the resolved word; None keeps the
    device rule."""
    from elemental_tpu_torch.kernels import resolve_panel
    assert resolve_panel("kernel", dtype=torch.float32,
                         device="cpu").impl == "kernel"
    assert resolve_panel(None, dtype=torch.float32,
                         device="cpu").impl == "torch"
    assert resolve_panel(None, dtype=torch.float32,
                         device="cuda").impl == "kernel"
