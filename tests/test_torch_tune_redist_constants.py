"""Measured redistribution constants in the port's cache (the twin of
``tests/tune/test_redist_constants.py``, without the fit and record of
``perf/redist_bench.py``, which wait for a multi-card machine): the
``redist_constants/v1`` round trip, its defensive loads, and the
engine's ``path='auto'`` arbitration reading them first."""
import json
import os

import numpy as np
import pytest

import elemental_tpu_torch as et
from elemental_tpu_torch.redist import engine as t_engine
from elemental_tpu_torch.tune import cache as tcache

GRID = (2, 2)


@pytest.fixture()
def cache_env(tmp_path, monkeypatch):
    monkeypatch.setenv(tcache.ENV_DIR, str(tmp_path))
    tcache.clear_redist_constants_memo()
    yield str(tmp_path)
    tcache.clear_redist_constants_memo()


def test_save_load_round_trip(cache_env):
    path = tcache.save_redist_constants(GRID, "cpu", alpha_s=3e-6,
                                        bw_bytes_per_s=1.25e10, nsamples=12)
    assert os.path.dirname(path) == cache_env
    doc = tcache.load_redist_constants(GRID, "cpu")
    assert doc["schema"] == tcache.REDIST_SCHEMA
    assert doc["alpha_s"] == pytest.approx(3e-6)
    assert doc["bw_bytes_per_s"] == pytest.approx(1.25e10)
    assert doc["nsamples"] == 12
    tcache.save_redist_constants(GRID, "cpu", alpha_s=5e-6,
                                 bw_bytes_per_s=1e10)
    assert tcache.load_redist_constants(GRID, "cpu")["alpha_s"] \
        == pytest.approx(5e-6)


def test_load_is_defensive(cache_env):
    assert tcache.load_redist_constants(GRID, "cpu") is None
    tcache.save_redist_constants(GRID, "cpu", 1e-6, 1e10)
    assert tcache.load_redist_constants((4, 2), "cpu") is None
    assert tcache.load_redist_constants(GRID, "gpu") is None
    name = tcache.redist_constants_filename(GRID, "cpu")
    with open(os.path.join(cache_env, name), "w") as fh:
        fh.write("{not json")
    tcache.clear_redist_constants_memo()
    assert tcache.load_redist_constants(GRID, "cpu") is None
    doc = {"schema": tcache.REDIST_SCHEMA, "grid": list(GRID),
           "backend": "cpu", "alpha_s": 1e-6, "bw_bytes_per_s": 0.0}
    with open(os.path.join(cache_env, name), "w") as fh:
        json.dump(doc, fh)
    tcache.clear_redist_constants_memo()
    assert tcache.load_redist_constants(GRID, "cpu") is None


def test_scan_skips_constants_files(cache_env):
    tcache.save_redist_constants(GRID, "cpu", 1e-6, 1e10)
    assert tcache.scan() == ([], [])


def test_machine_terms_read_the_recorded_constants_first(cache_env):
    """Without a record the arbitration prices with the tuner's machine
    row for the grid's backend; a record for (grid, backend) wins."""
    from elemental_tpu_torch.tune.cost_model import machine_for
    mm = machine_for("cpu")
    assert t_engine._machine_terms(GRID, "cpu") == (mm.latency_s,
                                                     mm.bw_bytes_per_s)
    g = machine_for("gpu")
    assert t_engine._machine_terms(GRID, "gpu") == (g.latency_s,
                                                    g.bw_bytes_per_s)
    tcache.save_redist_constants(GRID, "cpu", 7e-6, 3e9)
    assert t_engine._machine_terms(GRID, "cpu") == (7e-6, 3e9)


def test_recorded_constants_flip_the_arbitration(cache_env):
    """A latency-bound record (huge alpha) makes the one-round plan win
    where the ring model keeps the chain, and the engine's route follows:
    the route is what ``_direct_wins`` says under the record."""
    A = et.from_global(np.arange(64.0).reshape(8, 8), et.MC, et.MR,
                       et.Grid(2, 2, device="cpu"))
    plan = t_engine.direct_plan_for(A, et.MR, et.MC)
    before = t_engine._direct_wins(plan, A.gshape, 8, "cpu")
    tcache.save_redist_constants(GRID, "cpu", 1.0, 1e10)
    after = t_engine._direct_wins(plan, A.gshape, 8, "cpu")
    assert after and (before != after or before)
    with t_engine.redist_trace() as log:
        B = et.redistribute(A, et.MR, et.MC, path="auto")
    assert log[0].path == "direct" and log[0].fallback_reason == ""
    np.testing.assert_array_equal(et.to_global(B).numpy(),
                                  np.arange(64.0).reshape(8, 8))
