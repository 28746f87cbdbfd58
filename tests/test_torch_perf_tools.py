"""The port's perf tools (``elemental_tpu_torch.perf``) against the JAX
package's ``perf/`` on the CPU.

* ``redist_bench``: the rows' ``rounds``, ``model_bytes``, ``plan`` and
  ``match`` equal the JAX ``run_pair`` rows on every default pair at
  n = 64 on 2x4 (as ``tests/perf/test_redist_bench.py`` runs them);
  ``fit_constants`` equals the JAX fit on identical rows; ``--smoke``
  exits 0 and ``--record`` writes ``redist_constants/v1`` into the port's
  tuning cache only.
* ``ab_harness``: ``phases lu`` / ``phases cholesky`` print a
  ``phase_timings/v1`` document whose keys, step phases and metadata
  equal the JAX harness's at n = 256; every other mode completes at a
  small size.
* ``kernels smoke`` exits 0; the ``phase_timer`` import path re-exports
  the obs objects.

Every CLI exits 2 without a card unless ``--device cpu``.
"""
import importlib
import json
import runpy
import sys

import jax
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu_torch.perf import ab_harness, kernels, redist_bench

from perf import redist_bench as jax_bench


@pytest.fixture(scope="module")
def grids24():
    return el.Grid(jax.devices()[:8], height=2), et.Grid(2, 4, device="cpu")


@pytest.mark.parametrize("src,dst", redist_bench.DEFAULT_PAIRS,
                         ids=[f"{s}->{d}" for s, d in redist_bench.DEFAULT_PAIRS])
def test_redist_rows_equal_the_jax_rows(grids24, src, dst):
    jgrid, tgrid = grids24
    paths = ("chain", "direct")
    jrows = jax_bench.run_pair(jgrid, 64, jax_bench._dist_pair(src),
                               jax_bench._dist_pair(dst), paths, reps=1)
    trows = redist_bench.run_pair(tgrid, 64, redist_bench._dist_pair(src),
                                  redist_bench._dist_pair(dst), paths,
                                  reps=1)
    keys = ("schema", "pair", "grid", "n", "path", "plan", "rounds",
            "model_bytes", "match")
    assert [{k: r[k] for k in keys} for r in trows] \
        == [{k: r[k] for k in keys} for r in jrows]
    assert all(r["match"] is True and r["seconds"] > 0 for r in trows)


def test_fit_constants_equals_the_jax_fit():
    rows = [{"rounds": r, "model_bytes": b, "seconds": 3e-6 * r + b / 2e11
             + 1e-7 * i}
            for i, (r, b) in enumerate(((1, 4096), (2, 65536), (3, 8192),
                                        (1, 1 << 20), (0, 0)))]
    assert redist_bench.fit_constants(rows) == jax_bench.fit_constants(rows)
    flat = [{"rounds": 0, "model_bytes": 0, "seconds": 1e-5}] * 3
    assert redist_bench.fit_constants(flat) is None \
        and jax_bench.fit_constants(flat) is None


def test_p2p_gbps_reports_both_paths(grids24):
    doc = redist_bench.p2p_gbps(grids24[1], n=24, reps=1)
    assert set(doc) >= {"pair", "n", "grid", "chain", "direct"}
    assert doc["chain"] > 0.0 and doc["direct"] > 0.0


def test_redist_smoke_exits_zero(capsys):
    assert redist_bench.main(["--smoke", "--reps", "1", "--device",
                              "cpu"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.strip()]
    assert rows and all(r["schema"] == "redist_bench/v1" and r["match"]
                        for r in rows)


def test_redist_record_writes_the_port_cache(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("ELEMENTAL_TPU_TORCH_TUNE_CACHE", str(tmp_path))
    assert redist_bench.main(["--record", "--n", "32", "--grid", "2x2",
                              "--reps", "1", "--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert doc["schema"] == "redist_constants/v1"
    assert doc["grid"] == [2, 2] and doc["backend"] == "cpu"
    assert doc["_path"].startswith(str(tmp_path))


def _jax_harness():
    """The JAX harness module; its import points JAX's compilation cache
    at a directory of its own, which is put back here."""
    prev = jax.config.jax_compilation_cache_dir
    try:
        return importlib.import_module("perf.ab_harness")
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


@pytest.mark.parametrize("driver", ["lu", "cholesky"])
def test_phases_document_equals_the_jax_one(driver, capsys):
    jh = _jax_harness()
    jh.run_phases(driver, "256", "64")
    jdoc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tdoc = ab_harness.run_phases(ab_harness.Bench("cpu"), driver, "256",
                                 "64")
    assert json.loads(capsys.readouterr().out.strip()) == tdoc
    assert set(tdoc) == set(jdoc)
    assert [set(s) for s in tdoc["steps"]] == [set(s) for s in jdoc["steps"]]
    assert set(tdoc["totals"]) == set(jdoc["totals"])
    for key in ("schema", "driver", "n", "nb", "lookahead", "flops",
                "crossover", "inners"):
        assert tdoc.get(key) == jdoc.get(key), key


@pytest.mark.parametrize("argv", [
    ["chol", "128"], ["lu", "128"], ["cholesky", "128", "--grid", "2x2"],
    ["lu-dist", "128", "--grid", "2x2"], ["gemm", "64", "--grid", "2x2"],
    ["panel", "128"]], ids=lambda a: a[0])
def test_harness_mode_completes_on_the_cpu(argv, capsys):
    assert ab_harness.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if "TFLOP/s" in ln]
    assert rows, out
    if argv[0] == "panel":
        # plain and library rows for each primitive, nb and dtype; the
        # kernel rows name the CPU's plain route
        assert len(rows) == 3 * 2 * 2 * 2
        assert out.count("skip (cpu: plain route)") == 3 * 2 * 2


def test_kernels_smoke_exits_zero(capsys):
    assert kernels.main(["smoke", "--device", "cpu"]) == 0
    assert "kernels smoke OK" in capsys.readouterr().out


def test_phase_timer_path_reexports_obs():
    from elemental_tpu_torch import obs
    from elemental_tpu_torch.perf import phase_timer
    assert phase_timer.PhaseTimer is obs.PhaseTimer
    assert phase_timer.PHASES == obs.PHASES
    assert phase_timer.SCHEMA == obs.PHASE_TIMINGS_SCHEMA


@pytest.mark.parametrize("tool,argv", [
    (ab_harness, ["phases"]), (redist_bench, ["--smoke"]),
    (kernels, ["smoke"])], ids=["ab_harness", "redist_bench", "kernels"])
def test_cli_refuses_a_missing_card(tool, argv, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(argv) == 2


def test_example_refuses_a_missing_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["lu", "--n", "8"])
    with pytest.raises(SystemExit) as exc:
        runpy.run_module("elemental_tpu_torch.examples.lu",
                         run_name="__main__")
    assert exc.value.code == 2
