"""The port's persistent tuning cache (the twin of
``tests/tune/test_cache.py``): round trip, version/key rejection, atomic
writes, the private directory, clear, the unwritable-directory fallback,
and a file format byte-equal to the JAX package's."""
import json
import os
import warnings

import numpy as np
import pytest
import torch

import elemental_tpu_torch as et
from elemental_tpu_torch.obs import metrics as t_metrics
from elemental_tpu_torch.tune import cache as tc
from elemental_tpu_torch.tune import policy as tp


@pytest.fixture
def cache_env(tmp_path, monkeypatch):
    monkeypatch.setenv(tc.ENV_DIR, str(tmp_path))
    tp.clear_memo()
    yield tmp_path
    tp.clear_memo()


def _key(op="cholesky", dims=(3000, 3000), dtype="float32",
         grid=(2, 2), backend="cpu"):
    return tc.make_key(op, dims, dtype, grid, backend)


def test_the_cache_is_the_ports_own(monkeypatch):
    """Same schema and file names as the JAX package's, in another
    directory under another variable: a JAX entry (which names 'xla' /
    'pallas') never reaches the port's resolver."""
    from elemental_tpu.tune import cache as jc
    assert tc.SCHEMA == jc.SCHEMA and tc.REDIST_SCHEMA == jc.REDIST_SCHEMA
    assert tc.ENV_DIR == "ELEMENTAL_TPU_TORCH_TUNE_CACHE" != jc.ENV_DIR
    monkeypatch.delenv(tc.ENV_DIR, raising=False)
    monkeypatch.delenv(jc.ENV_DIR, raising=False)
    assert tc.cache_dir().endswith(os.path.join(".cache",
                                                "elemental_tpu_torch",
                                                "tuning"))
    assert tc.cache_dir() != jc.cache_dir()
    assert _key().filename() == jc.make_key(
        "cholesky", (3000, 3000), "float32", (2, 2), "cpu").filename()


def test_a_jax_entry_never_reaches_the_port(tmp_path, monkeypatch):
    from elemental_tpu.tune import cache as jc
    monkeypatch.setenv(jc.ENV_DIR, str(tmp_path / "jax"))
    monkeypatch.setenv(tc.ENV_DIR, str(tmp_path / "torch"))
    tp.clear_memo()
    jk = jc.make_key("cholesky", (64, 64), "float32", (1, 1), "cpu")
    jc.save(jk, {"nb": 8, "lookahead": False, "crossover": 0,
                 "panel_impl": "pallas"})
    res = et.tune.resolve("cholesky", gshape=(64, 64), dtype=torch.float32,
                          grid=et.Grid(device="cpu"),
                          requested={"nb": "auto", "panel_impl": "auto"})
    assert res.source == "cost_model"
    assert res.config["panel_impl"] in ("torch", "kernel")
    tp.clear_memo()


def test_file_is_byte_equal_to_the_jax_save(tmp_path, monkeypatch):
    from elemental_tpu.tune import cache as jc
    monkeypatch.setenv(jc.ENV_DIR, str(tmp_path / "jax"))
    monkeypatch.setenv(tc.ENV_DIR, str(tmp_path / "torch"))
    cfg = {"nb": 2048, "lookahead": True, "crossover": 4096,
           "comm_precision": None, "redist_path": None}
    metric = {"seconds": 0.5, "tflops": 1.25}
    key = ("cholesky", (32768, 32768), "float32", (1, 1), "gpu")
    pj = jc.save(jc.make_key(*key), cfg, metric=metric)
    pt = tc.save(tc.make_key(*key), cfg, metric=metric)
    assert os.path.basename(pj) == os.path.basename(pt)

    def body(path):
        doc = json.loads(open(path).read())
        doc.pop("created")
        return doc, open(path).read().count("\n")
    assert body(pt) == body(pj)
    strip = [ln for ln in open(pt).read().splitlines()
             if '"created"' not in ln]
    assert strip == [ln for ln in open(pj).read().splitlines()
                     if '"created"' not in ln]


def test_round_trip(cache_env):
    key = _key()
    cfg = {"nb": 1024, "lookahead": True, "crossover": 4096}
    path = tc.save(key, cfg, source="measured",
                   metric={"seconds": 0.5, "tflops": 1.25})
    assert os.path.dirname(path) == str(cache_env)
    doc = tc.load(key)
    assert doc["config"] == cfg and doc["source"] == "measured"
    assert doc["schema"] == tc.SCHEMA and doc["metric"]["tflops"] == 1.25
    assert [f for f in os.listdir(cache_env) if f.endswith(".tmp")] == []


def test_shape_bucketing_shares_entries(cache_env):
    tc.save(_key(dims=(3000, 3000)), {"nb": 512})
    assert tc.load(_key(dims=(4096, 4096)))["config"] == {"nb": 512}
    assert tc.load(_key(dims=(4097, 4097))) is None
    assert tc.shape_bucket((1, 2, 3, 64, 65)) == (1, 2, 4, 64, 128)


def test_version_mismatch_rejected(cache_env):
    key = _key()
    tc.save(key, {"nb": 256})
    doc = json.load(open(key.path()))
    doc["schema"] = "tuning_cache/v0"
    json.dump(doc, open(key.path(), "w"))
    assert tc.load(key) is None


def test_key_field_mismatch_and_corrupt_file_rejected(cache_env):
    a, b = _key(op="cholesky"), _key(op="lu")
    tc.save(a, {"nb": 256})
    os.replace(a.path(), b.path())
    assert tc.load(b) is None and tc.load(a) is None
    with open(a.path(), "w") as f:
        f.write("{not json")
    with t_metrics.scoped() as reg:
        assert tc.load(a) is None
        assert reg.counter_value("tune_cache_events", op="cholesky",
                                 event="unparsable") == 1


def test_clear_by_op(cache_env):
    tc.save(_key(op="cholesky"), {"nb": 256})
    tc.save(_key(op="lu"), {"nb": 512})
    assert len(tc.entries()) == 2
    assert tc.clear("cholesky") == 1
    assert [d["op"] for d in tc.entries()] == ["lu"]
    assert tc.clear() == 1 and tc.entries() == []


def test_resolver_prefers_cache_and_explicit_wins(cache_env):
    grid = et.Grid(2, 2, device="cpu")
    req = {"nb": "auto", "lookahead": "auto", "crossover": "auto"}
    r0 = et.tune.resolve("cholesky", gshape=(64, 64), dtype=torch.float32,
                         grid=grid, requested=req)
    assert r0.source == "cost_model" and isinstance(r0.config["nb"], int)
    key = tc.make_key("cholesky", (64, 64), "float32", (2, 2), "cpu")
    epoch = tc.epoch()
    tc.save(key, {"nb": 32, "lookahead": False, "crossover": 0})
    assert tc.epoch() == epoch + 1
    et.tune.clear_memo()
    r1 = et.tune.resolve("cholesky", gshape=(64, 64), dtype=torch.float32,
                         grid=grid, requested=req)
    assert r1.source == "cache"
    assert r1.config == {"nb": 32, "lookahead": False, "crossover": 0}
    kn = et.tune.resolve_knobs("cholesky", gshape=(64, 64),
                               dtype=torch.float32, grid=grid,
                               knobs={"nb": 16, "lookahead": "auto",
                                      "crossover": "auto"})
    assert kn == {"nb": 16, "lookahead": False, "crossover": 0}


def test_a_cuda_grid_keys_the_gpu_backend(cache_env):
    """The backend word comes from the grid's device: 'gpu' for CUDA,
    and the dtype's canonical name, not torch's spelling."""
    res = et.tune.resolve("gemm", gshape=(64, 32, 16), dtype=torch.float32,
                          grid=et.Grid(device="cuda"),
                          requested={"alg": "auto", "nb": None})
    assert res.key.filename() == "gemm__b64x32x16__float32__g1x1__gpu.json"
    assert res.config == {"alg": "dot"}


@pytest.fixture
def unwritable_cache(tmp_path, monkeypatch):
    blocker = tmp_path / "blocker.txt"
    blocker.write_text("not a directory\n")
    bad = str(blocker / "cache")
    monkeypatch.setenv(tc.ENV_DIR, bad)
    tp.clear_memo()
    tc._MEM_FALLBACK.clear()
    tc._WARNED_DIRS.discard(bad)
    yield bad
    tc._MEM_FALLBACK.clear()
    tc._WARNED_DIRS.discard(bad)
    tp.clear_memo()


def test_unwritable_dir_save_never_raises(unwritable_cache):
    key = _key()
    cfg = {"nb": 128, "lookahead": True, "crossover": 0}
    with t_metrics.scoped() as reg:
        with pytest.warns(RuntimeWarning, match="not writable"):
            tc.save(key, cfg)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tc.save(_key(op="lu"), {"nb": 64})
        assert not [w for w in caught
                    if issubclass(w.category, RuntimeWarning)]
        assert tc.load(key)["config"] == cfg
        assert reg.counter_value("tune_cache_events", op="cholesky",
                                 event="write_fallback") == 1
        assert reg.counter_value("tune_cache_events", op="cholesky",
                                 event="mem_hit") == 1
    assert tc.clear("cholesky") == 0
    assert tc.load(key) is None


def test_unwritable_dir_auto_resolution_survives(unwritable_cache):
    grid = et.Grid(2, 2, device="cpu")
    req = {"nb": "auto", "lookahead": "auto", "crossover": "auto"}
    r = et.tune.resolve("cholesky", gshape=(32, 32), dtype=np.float32,
                        grid=grid, requested=req)
    assert r.source == "cost_model"
    key = tc.make_key("cholesky", (32, 32), "float32", (2, 2), "cpu")
    with pytest.warns(RuntimeWarning, match="not writable"):
        tc.save(key, {"nb": 16, "lookahead": False, "crossover": 0})
    et.tune.clear_memo()
    r2 = et.tune.resolve("cholesky", gshape=(32, 32), dtype=np.float32,
                         grid=grid, requested=req)
    assert r2.source == "cache" and r2.config["nb"] == 16
