"""The port's memory term (the twin of ``tests/tune/test_peak_bytes.py``):
every scored candidate carries a per-rank peak (a closed form per op);
candidates over the machine's device memory are pruned -- ranked behind
every fitting one -- and an all-pruned space still resolves."""
import dataclasses

import numpy as np
import pytest

import elemental_tpu_torch as et
from elemental_tpu_torch.tune import TuneContext, policy
from elemental_tpu_torch.tune import cost_model as cm


@pytest.fixture(autouse=True)
def empty_cache(tmp_path, monkeypatch):
    from elemental_tpu_torch.tune import cache as tc
    monkeypatch.setenv(tc.ENV_DIR, str(tmp_path))
    policy.clear_memo()
    yield
    policy.clear_memo()


def _grid(r, c):
    return et.Grid(r, c, device="cpu")


def _ctx(op, dims, shape=(2, 2)):
    return TuneContext(op, dims, "float32", shape, "cpu")


def _tiny_machine(hbm=1024.0):
    return dataclasses.replace(cm.machine_for("cpu"), hbm_bytes=hbm)


def test_traced_breakdown_carries_peak_bytes():
    b = cm.score_config("cholesky", {"nb": 16, "lookahead": False,
                                     "crossover": 0},
                        ctx=_ctx("cholesky", (64, 64)))
    assert b.peak_bytes > 0 and not b.pruned
    doc = b.to_doc()
    assert doc["peak_bytes"] == b.peak_bytes and doc["pruned"] is False


def test_gemm_closed_form_peak_is_sane():
    m = k = n = 256
    b = cm.score_config("gemm", {"alg": "A", "nb": 64,
                                 "comm_precision": None,
                                 "redist_path": "gather"},
                        ctx=_ctx("gemm", (m, k, n)))
    shards = (m * k + k * n + m * n) * 4 / 4
    assert shards <= b.peak_bytes < 3 * (m * k + k * n + m * n) * 4
    assert not b.pruned


def test_tiny_hbm_prunes_candidates():
    tiny = _tiny_machine()
    for op, dims, config in [
            ("cholesky", (64, 64), {"nb": 16, "lookahead": False,
                                    "crossover": 0}),
            ("gemm", (256, 256, 256), {"alg": "A", "nb": 64,
                                       "comm_precision": None,
                                       "redist_path": "gather"})]:
        b = cm.score_config(op, config, ctx=_ctx(op, dims), machine=tiny)
        assert b.pruned and b.to_doc()["pruned"] is True


def test_explain_ranks_pruned_candidates_last():
    _, scored = policy.explain("cholesky", gshape=(64, 64),
                               dtype=np.float32, grid=_grid(2, 2),
                               machine=_tiny_machine(hbm=2.0e4))
    flags = [b.pruned for b in scored]
    assert any(flags) and not all(flags)
    assert flags == sorted(flags)


def test_all_pruned_still_resolves():
    res = policy.resolve("cholesky", gshape=(64, 64), dtype=np.float32,
                         grid=_grid(2, 2),
                         requested={"nb": "auto", "lookahead": "auto",
                                    "crossover": "auto"},
                         machine=_tiny_machine())
    assert res.config["nb"] is not None
    _, scored = policy.explain("cholesky", gshape=(64, 64),
                               dtype=np.float32, grid=_grid(2, 2),
                               machine=_tiny_machine())
    assert all(b.pruned for b in scored)


def test_pruning_overrides_modeled_time():
    ctx = _ctx("cholesky", (64, 64))
    fast = cm.score_config("cholesky", {"nb": 32, "lookahead": True,
                                        "crossover": 0}, ctx=ctx)
    slow = cm.score_config("cholesky", {"nb": 8, "lookahead": False,
                                        "crossover": 0}, ctx=ctx)
    a, b = sorted([fast, slow], key=lambda x: x.total_s)
    forced = dataclasses.replace(a, pruned=True)
    assert sorted([forced, b], key=lambda x: (x.pruned, x.total_s))[0] is b


def test_the_full_size_flagships_fit_the_card():
    """At the flagship sizes on one card the peak stays under the 'gpu'
    row's 80 GiB, so nothing the smoke run resolves is pruned."""
    for op, dims in (("cholesky", (32768, 32768)), ("lu", (32768, 32768)),
                     ("qr", (65536, 32768))):
        ctx = TuneContext(op, dims, "float32", (1, 1), "gpu")
        b = cm.score_config(op, {"nb": 2048, "lookahead": True,
                                 "crossover": 4096}, ctx=ctx)
        assert 0 < b.peak_bytes < cm.machine_for("gpu").hbm_bytes
        assert not b.pruned
