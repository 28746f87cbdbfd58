"""The port's tuner against the JAX package's on the CPU: the cost
model's terms, the comm term of every comm-plan golden's op, and the
resolutions themselves, on the same contexts and with empty caches.

The port has no jaxpr: its comm term probes the port's driver on a CPU
grid and maps each recorded entry to the collectives the JAX lowering
emits (``redist.engine.collective_sites``).  The reference is the JAX
cost model's own ``score_config`` on the same context -- not the golden
files: where the two disagree, that is a finding of the JAX package.
JAX references run on 1x1 and 2x2 grids only."""
import functools
import math
import subprocess
import sys

import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.tune import TuneContext as JCtx
from elemental_tpu.tune import cost_model as jcm
from elemental_tpu.tune import policy as jpol
from elemental_tpu_torch.tune import TuneContext as TCtx
from elemental_tpu_torch.tune import cost_model as tcm
from elemental_tpu_torch.tune import policy as tpol

GRIDS = [(1, 1), (2, 2)]
N, NB, XO = 64, 16, 32            # the golden comm-plan geometry


@functools.cache
def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c, device="cpu"):
    return et.Grid(r, c, device=device)


@pytest.fixture(scope="module", autouse=True)
def empty_caches(tmp_path_factory):
    """Both tuners on empty caches for the whole module (the JAX trace
    memo is kept across tests: the probes are the slow part)."""
    import os
    from elemental_tpu.tune import cache as jc
    from elemental_tpu_torch.tune import cache as tc
    d = tmp_path_factory.mktemp("tune")
    old = {k: os.environ.get(k) for k in (jc.ENV_DIR, tc.ENV_DIR)}
    os.environ[jc.ENV_DIR] = str(d / "jax")
    os.environ[tc.ENV_DIR] = str(d / "torch")
    jpol._RESOLVE_MEMO.clear()
    tpol.clear_memo()
    yield
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    jpol._RESOLVE_MEMO.clear()
    tpol.clear_memo()


def _pair(op, cfg, dims, rc, backend="cpu"):
    """(JAX breakdown, port breakdown) of one candidate on one context."""
    jb = jcm.score_config(op, cfg, ctx=JCtx(op, dims, "float32", rc, backend),
                          grid=jgrid(*rc), dtype=np.float32)
    tb = tcm.score_config(op, cfg, ctx=TCtx(op, dims, "float32", rc, backend))
    return jb, tb


#: every comm-plan golden's op and schedule, as cost-model configs
#: (``trsm_r`` has no cost-model twin: the model prices the left solve;
#: the ``*_abft`` guards and the non-tunable ``qr_lq`` / ``redist_*`` are
#: not cost-model ops)
GOLDEN_CONFIGS = {
    "cholesky_classic": ("cholesky", {"lookahead": False, "crossover": 0}),
    "cholesky_lookahead": ("cholesky", {"lookahead": True, "crossover": 0}),
    "cholesky_crossover": ("cholesky", {"lookahead": True, "crossover": XO}),
    "cholesky_lookahead_commq": ("cholesky", {"lookahead": True,
                                              "crossover": 0,
                                              "comm_precision": "int8"}),
    "lu_classic": ("lu", {"lookahead": False, "crossover": 0}),
    "lu_lookahead": ("lu", {"lookahead": True, "crossover": 0}),
    "lu_crossover": ("lu", {"lookahead": True, "crossover": XO}),
    "lu_calu": ("lu", {"lookahead": True, "crossover": XO, "panel": "calu"}),
    "lu_calu_commq": ("lu", {"lookahead": True, "crossover": XO,
                             "panel": "calu", "comm_precision": "bf16"}),
    "qr": ("qr", {"panel": "classic"}),
    "qr_tsqr": ("qr", {"panel": "tsqr"}),
    "trsm": ("trsm", {}),
    "trsm_direct": ("trsm", {"redist_path": "direct"}),
    "herk": ("herk", {}),
    "herk_direct": ("herk", {"redist_path": "direct"}),
}


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("name", sorted(GOLDEN_CONFIGS))
def test_comm_term_equals_the_jax_model_on_every_golden_op(name, rc):
    op, cfg = GOLDEN_CONFIGS[name]
    jb, tb = _pair(op, {"nb": NB, **cfg}, (N, N), rc)
    assert tb.prim_counts == jb.prim_counts
    assert tb.rounds == jb.rounds
    assert tb.comm_bytes == jb.comm_bytes
    # the closed-form memory term stays within 2x of the liveness walk
    assert 0.5 <= tb.peak_bytes / jb.peak_bytes <= 2.0, \
        (tb.peak_bytes, jb.peak_bytes)
    assert tb.pruned == jb.pruned


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("rp", [None, "direct"])
@pytest.mark.parametrize("alg", ["dot", "C", "A", "B", "gspmd", "slice"])
def test_gemm_closed_forms_equal_the_jax_model(alg, rp, rc):
    for dims in ((N, N, N), (96, 40, 24)):
        jb, tb = _pair("gemm", {"alg": alg, "nb": NB, "redist_path": rp,
                                "comm_precision": None}, dims, rc)
        assert tb.to_doc() == jb.to_doc()


def test_large_problem_extrapolates_without_probing_full_size():
    """n = 32768 scores through the scaled probe geometry (bounded step
    count), with latency extrapolated to the real step count -- and the
    same extrapolated terms as the JAX model."""
    jb, tb = _pair("cholesky", {"nb": 2048, "lookahead": True,
                                "crossover": 0}, (32768, 32768), (2, 2))
    assert max(tb.detail["trace_dims"]) <= 128
    assert tb.detail["lat_scale"] > 1
    assert tb.rounds > sum(tb.prim_counts.values())
    assert (tb.rounds, tb.comm_bytes, tb.prim_counts) == \
        (jb.rounds, jb.comm_bytes, jb.prim_counts)
    assert tb.detail == jb.detail


#: the contexts the JAX tune tests resolve, as the drivers ask them:
#: every knob of the op at its driver default, the named ones 'auto'
_DEFAULTS = {
    "cholesky": {"nb": None, "lookahead": True, "crossover": None,
                 "panel_impl": None, "comm_precision": None,
                 "redist_path": None},
    "lu": {"nb": None, "lookahead": True, "crossover": None,
           "panel": "classic", "panel_impl": None, "comm_precision": None,
           "redist_path": None},
    "qr": {"nb": None, "panel": "classic", "panel_impl": None,
           "comm_precision": None, "redist_path": None},
    "gemm": {"alg": "auto", "nb": None, "comm_precision": None,
             "redist_path": None},
    "trsm": {"nb": None, "comm_precision": None, "redist_path": None},
    "herk": {"nb": None, "comm_precision": None, "redist_path": None},
}
_AUTO3 = {"nb": "auto", "lookahead": "auto", "crossover": "auto"}
CONTEXTS = [
    ("cholesky", (24, 24), _AUTO3),
    ("lu", (24, 24), _AUTO3),
    ("qr", (24, 16), {"nb": "auto"}),
    ("gemm", (24, 32, 20), {"nb": "auto"}),
    ("trsm", (24, 8), {"nb": "auto"}),
    ("herk", (24, 32), {"nb": "auto"}),
    ("cholesky", (64, 64), _AUTO3),
    ("cholesky", (64, 64), {"nb": 16, "crossover": 0,
                            "comm_precision": "auto"}),
    ("cholesky", (64, 64), {"nb": 16, "crossover": 0,
                            "redist_path": "auto"}),
    ("lu", (64, 64), {"panel": "auto"}),
    ("qr", (64, 64), {"panel": "auto"}),
    ("gemm", (64, 64, 64), {}),
]


def _jax_resolve(op, dims, rc, backend, requested, monkeypatch):
    """The JAX package's resolution on a ``backend`` context (its
    ``_context`` reads the backend off the devices, so a 'gpu' context
    is substituted)."""
    real = jpol._context

    def ctx(*a, **k):
        import dataclasses
        return dataclasses.replace(real(*a, **k), backend=backend)
    monkeypatch.setattr(jpol, "_context", ctx)
    jpol._RESOLVE_MEMO.clear()
    return jpol.resolve(op, gshape=dims, dtype=np.float32, grid=jgrid(*rc),
                        requested=requested)


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("i", range(len(CONTEXTS)),
                         ids=[f"{c[0]}-{'x'.join(map(str, c[1]))}-"
                              f"{'-'.join(sorted(c[2]))}" for c in CONTEXTS])
def test_resolutions_equal_the_jax_package(i, rc, backend, monkeypatch):
    op, dims, autos = CONTEXTS[i]
    requested = {**_DEFAULTS[op], **autos}
    jr = _jax_resolve(op, dims, rc, backend, requested, monkeypatch)
    tr = tpol.resolve(op, gshape=dims, dtype=np.float32,
                      grid=tgrid(*rc, "cuda" if backend == "gpu" else "cpu"),
                      requested=requested)
    assert (tr.source, tr.config) == (jr.source, jr.config)
    assert tr.key.filename() == jr.key.filename()


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("op", ["cholesky", "lu", "qr", "trsm", "herk",
                                "gemm"])
def test_explain_ranks_and_prices_as_the_jax_package(op, rc):
    """Every knob 'auto' on the 'cpu' backend (lu's route pinned to the
    chain on 2x2, to halve the JAX traces): the same candidates in the
    same order (after the panel_impl word map), and compute / pivot /
    decode / panel-launch terms within 1e-12."""
    dims = (24, 20, 16) if op == "gemm" else (24, 16)
    req = {k: "auto" for k in et.tune.OPS[op].knobs}
    if op == "lu" and rc != (1, 1):
        req["redist_path"] = None
    _, js = jpol.explain(op, gshape=dims, dtype=np.float32, grid=jgrid(*rc),
                         requested=req)
    _, ts = tpol.explain(op, gshape=dims, dtype=np.float32, grid=tgrid(*rc),
                         requested=req)
    words = {"xla": "torch", "pallas": "kernel"}

    def mapped(cfg):
        return {k: words.get(v, v) if k == "panel_impl" else v
                for k, v in cfg.items()}
    assert [b.config for b in ts] == [mapped(b.config) for b in js]
    for jb, tb in zip(js, ts):
        for term in ("compute_s", "pivot_s", "decode_s", "panel_impl_s",
                     "latency_s", "bandwidth_s"):
            assert math.isclose(getattr(tb, term), getattr(jb, term),
                                rel_tol=1e-12, abs_tol=0), term


def test_gpu_terms_equal_the_jax_package_but_the_panel_launches():
    """On a 'gpu' context the kernel is native: every term but the
    panel-launch one equals the JAX model's (where 'pallas' pays the
    interpret penalty off-TPU)."""
    for impl, jimpl in (("torch", "xla"), ("kernel", "pallas")):
        cfg = {"nb": 16, "lookahead": True, "crossover": 0}
        jb = jcm.score_config("lu", {**cfg, "panel_impl": jimpl},
                              ctx=JCtx("lu", (64, 64), "float32", (2, 2),
                                       "gpu"),
                              grid=jgrid(2, 2), dtype=np.float32)
        tb = tcm.score_config("lu", {**cfg, "panel_impl": impl},
                              ctx=TCtx("lu", (64, 64), "float32", (2, 2),
                                       "gpu"))
        for term in ("compute_s", "pivot_s", "decode_s", "latency_s",
                     "bandwidth_s"):
            assert math.isclose(getattr(tb, term), getattr(jb, term),
                                rel_tol=1e-12)
        if impl == "torch":
            assert tb.panel_impl_s == jb.panel_impl_s
        else:
            assert tb.panel_impl_s == 4 * tcm.machine_for("gpu").latency_s


@pytest.mark.parametrize("op", ["cholesky", "lu"])
def test_lookahead_crossover_ranks_at_or_above_classic_2x2(op):
    classic = tcm.score_config(op, {"nb": NB, "lookahead": False,
                                    "crossover": 0},
                               ctx=TCtx(op, (N, N), "float32", (2, 2), "cpu"))
    xover = tcm.score_config(op, {"nb": NB, "lookahead": True,
                                  "crossover": XO},
                             ctx=TCtx(op, (N, N), "float32", (2, 2), "cpu"))
    assert xover.prim_counts["all_gather"] < classic.prim_counts["all_gather"]
    assert xover.total_s <= classic.total_s
    assert (xover.latency_s + xover.bandwidth_s
            <= classic.latency_s + classic.bandwidth_s)


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("op", ["cholesky", "lu", "qr", "trsm", "herk",
                                "gemm"])
def test_all_candidates_finite_positive(op, rc):
    dims = (256, 256, 256) if op == "gemm" else (256, 256)
    _, scored = et.tune.explain(op, gshape=dims, dtype=np.float32,
                                grid=tgrid(*rc))
    assert scored
    for b in scored:
        assert math.isfinite(b.total_s) and b.total_s > 0, b.to_doc()
        assert b.compute_s > 0 and b.latency_s >= 0 and b.bandwidth_s >= 0
    if rc == (1, 1):
        assert all(b.rounds == 0 and b.comm_bytes == 0 for b in scored)


def test_machine_rows_are_the_jax_packages_gpu_and_cpu_rows():
    for name in ("gpu", "cpu"):
        assert tcm.MACHINES[name].__dict__ == jcm.MACHINES[name].__dict__
    assert set(tcm.MACHINES) == {"gpu", "cpu"}
    assert tcm.machine_for("tpu") == tcm.MACHINES["cpu"]
    for k in ("TRACE_REAL_LIMIT", "_MAX_TRACE_STEPS", "HALF_NB", "IMB",
              "WIRE_FACTORS", "DECODE_PASSES", "INTERPRET_PENALTY"):
        assert getattr(tcm, k) == getattr(jcm, k), k


def test_crossover_default_matches_driver_constants():
    from elemental_tpu_torch.tune.knobs import DEFAULT_CROSSOVER
    import importlib
    chol = importlib.import_module("elemental_tpu_torch.lapack.cholesky")
    lu = importlib.import_module("elemental_tpu_torch.lapack.lu")
    assert DEFAULT_CROSSOVER == chol._CROSSOVER == lu._CROSSOVER


def test_gemm_regime_selection():
    kn = et.tune.resolve_knobs("gemm", gshape=(32, 8192, 32),
                               dtype=np.float32, grid=tgrid(2, 2),
                               knobs={"alg": "auto", "nb": None})
    assert kn["alg"] in ("dot", "gspmd") and kn["nb"] is None
    kn1 = et.tune.resolve_knobs("gemm", gshape=(256, 256, 256),
                                dtype=np.float32, grid=tgrid(1, 1),
                                knobs={"alg": "auto", "nb": None})
    assert kn1["alg"] == "dot"


def test_explain_cli_self_check_passes_on_the_cpu(tmp_path):
    """``python -m elemental_tpu_torch.tune explain`` scores on a CPU
    grid, prints the ranking and exits 0 when the self-check holds."""
    import os
    env = dict(os.environ, ELEMENTAL_TPU_TORCH_TUNE_CACHE=str(tmp_path))
    out = subprocess.run([sys.executable, "-m", "elemental_tpu_torch.tune",
                          "explain", "lu", "--n", "64"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "self-check ok" in out.stdout and "chosen:" in out.stdout


def test_chip_smoke_pins_the_cpu_resolutions():
    """The configs ``chip_smoke.py`` phase 3k gates its cold resolutions
    on the card against are the ones the tuner computes here, on the CPU,
    for the same contexts (a 1x1 CUDA grid: backend 'gpu')."""
    from chip_smoke import TUNER_PINS
    assert set(TUNER_PINS) == set(et.tune.OPS)
    for op, (dims, pin) in TUNER_PINS.items():
        requested = {k: "auto" for k in et.tune.OPS[op].knobs}
        r = tpol.resolve(op, gshape=dims, dtype=np.float32,
                         grid=tgrid(1, 1, "cuda"), requested=requested)
        assert (r.source, r.config) == ("cost_model", pin), op
