"""The port's batched executor against the JAX package's: the padding
bit for bit, the batched solves of every op (the JAX vmapped kernel's to
1e-12 in f64), the entry keys byte for byte, the cache's
miss/compile/hit counters, tuner-fed routing under one shared tuning
cache, and the closed-form batch peak against the JAX liveness walk."""
import jax.numpy as jnp
import numpy as np
import pytest

import elemental_tpu.serve as jserve
import elemental_tpu_torch.serve as tserve
from elemental_tpu.obs import metrics as jmetrics
from elemental_tpu.serve.executor import batch_peak_bytes as j_peak
from elemental_tpu_torch.obs import metrics as tmetrics
from elemental_tpu_torch.serve.executor import batch_peak_bytes as t_peak

from .torch_serve_common import (X_TOL, cpu_default_grid,  # noqa: F401
                                 diag_dom, spd)


def _problems(op, rng):
    if op == "lstsq":
        return [(rng.normal(size=(m, n)), rng.normal(size=(m, 2)))
                for m, n in ((20, 12), (16, 9), (21, 16), (18, 14))]
    make = spd if op == "hpd" else diag_dom
    return [(make(rng, n), rng.normal(size=(n, 2))) for n in (12, 16, 9, 14)]


@pytest.mark.parametrize("op", ["lu", "hpd", "lstsq"])
def test_padding_is_bit_equal(op):
    rng = np.random.default_rng(30)
    for A, B in _problems(op, rng):
        m = A.shape[0] if op == "lstsq" else None
        bj = jserve.make_bucket(op, A.shape[1], B.shape[1], A.dtype, m=m)
        bt = tserve.make_bucket(op, A.shape[1], B.shape[1], A.dtype, m=m)
        assert bt.key() == bj.key()
        pj = jserve.pad_problem_ls if op == "lstsq" else jserve.pad_problem
        pt = tserve.pad_problem_ls if op == "lstsq" else tserve.pad_problem
        for x, y in zip(pt(A, B, bt), pj(A, B, bj)):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("op", ["lu", "hpd", "lstsq"])
def test_batched_solve_matches_the_jax_vmapped_kernel(op):
    """One bucket, four requests of mixed true size: the port's executor
    against the JAX package's (its vmapped ``_kernel``), f64."""
    rng = np.random.default_rng(31)
    probs = _problems(op, rng)
    out = []
    for pkg in (jserve, tserve):
        ctrl = pkg.AdmissionController()
        reqs = [ctrl.admit(op, A, B) for A, B in probs]
        assert len({r.bucket for r in reqs}) == 1
        xs, seconds = pkg.Executor().run(reqs[0].bucket, reqs)
        assert seconds >= 0.0
        out.append(xs)
    meas = tserve.ls_residual if op == "lstsq" else tserve.residual
    for (A, B), xj, xt in zip(probs, *out):
        assert xt.dtype == np.float64
        assert xt.shape == xj.shape == (A.shape[1], B.shape[1])
        np.testing.assert_allclose(xt, xj, rtol=0, atol=X_TOL)
        assert meas(A, B, xt) <= 64 * A.shape[1] * np.finfo(np.float64).eps


def test_batched_padded_slots_match_the_jax_kernel_directly():
    """The raw batched function on a padded (slots, n, n) stack against
    ``jax.vmap`` of the JAX one-problem kernel: identity pad slots stay
    exact identity solves."""
    import jax
    import torch
    from elemental_tpu.serve.executor import _kernel as j_kernel
    from elemental_tpu_torch.serve.executor import _kernel as t_kernel
    rng = np.random.default_rng(32)
    for op, rows in (("lu", 16), ("hpd", 16), ("lstsq", 32)):
        a = np.zeros((4, rows, 16))
        a[:, :16, :] = np.eye(16)
        b = np.zeros((4, rows, 2))
        for i, (A, B) in enumerate(_problems(op, rng)[:2]):
            bk = tserve.make_bucket(op, A.shape[1], 2, A.dtype,
                                    m=A.shape[0] if op == "lstsq" else None)
            pad = tserve.pad_problem_ls if op == "lstsq" \
                else tserve.pad_problem
            a[i], b[i] = pad(A, B, bk)
        xj = np.asarray(jax.vmap(j_kernel(op))(jnp.asarray(a),
                                               jnp.asarray(b)))
        xt = t_kernel(op)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(xt, xj, rtol=0, atol=X_TOL)
        np.testing.assert_array_equal(xt[2:], 0.0)


def test_entry_keys_are_the_jax_keys_byte_for_byte():
    import jax
    cases = [("hpd", 100, 2, np.float32, None), ("lu", 12, 2, np.float64, None),
             ("lstsq", 12, 3, np.float64, 40)]
    for op, n, k, dt, m in cases:
        bj = jserve.make_bucket(op, n, k, dt, m=m)
        bt = tserve.make_bucket(op, n, k, dt, m=m)
        for slots in (1, 8):
            for tune, donate, dev in (("", False, None),
                                      ("1a2b3c4d", True, 3), ("", True, 0)):
                kj = jserve.ExecutableCache.key(
                    op, bj, slots, "cpu", tune=tune, donate=donate,
                    device=None if dev is None else jax.devices()[dev])
                kt = tserve.ExecutableCache.key(
                    op, bt, slots, "cpu", tune=tune, donate=donate,
                    device=None if dev is None
                    else tserve.RankSlot(dev, "cpu"))
                assert kt == kj
    assert tserve.ExecutableCache.key("hpd", tserve.make_bucket(
        "hpd", 100, 2, np.float32), 8, "gpu") \
        == "hpd__b128x2__x8__float32__gpu"


def _cache_story(pkg, metrics):
    rng = np.random.default_rng(12)
    ctrl = pkg.AdmissionController()
    reqs = [ctrl.admit("lu", diag_dom(rng, 12), rng.normal(size=(12, 1)))
            for _ in range(3)]
    ex = pkg.Executor()
    with metrics.scoped() as reg:
        b = reqs[0].bucket
        for part in (reqs, reqs, reqs[:1], reqs[:1]):
            ex.run(b, part)
        ex.run(b, reqs[:2], donate=True)
        counts = {dict(lb)["event"]: v for (_, lb), v in
                  reg.counters("serve_exec_cache_events").items()}
        batches = reg.counter_value("serve_batches", op="lu")
    entries = ex.cache.stats()["entries"]
    ex.cache.clear()
    return counts, batches, entries, ex.cache.stats()["entries"]


def test_cache_counters_and_entries_equal():
    j = _cache_story(jserve, jmetrics)
    t = _cache_story(tserve, tmetrics)
    assert t == j
    assert t[0] == {"miss": 3, "compile": 3, "hit": 2}


@pytest.fixture
def shared_tune_cache(tmp_path, monkeypatch):
    """Both packages' tuning caches in ONE directory: the port reads the
    entries the JAX package writes (same file names, same schema).  A
    write bumps only the writing package's in-process epoch, so the test
    bumps the port's after each JAX write, as a re-sweep in the port's
    own process would."""
    from elemental_tpu.tune import cache as jtc
    from elemental_tpu.tune import policy as jpol
    from elemental_tpu_torch.tune import cache as ttc
    from elemental_tpu_torch.tune import policy as tpol
    monkeypatch.setenv(jtc.ENV_DIR, str(tmp_path))
    monkeypatch.setenv(ttc.ENV_DIR, str(tmp_path))
    jpol._RESOLVE_MEMO.clear()
    tpol.clear_memo()
    def save(*a, **kw):
        jtc.save(*a, **kw)
        ttc._bump_epoch()
    yield jtc, save
    jpol._RESOLVE_MEMO.clear()
    tpol.clear_memo()


def test_route_for_and_tune_token_equal_under_one_cache(shared_tune_cache):
    jtc, save = shared_tune_cache
    b = {pkg: pkg.make_bucket("hpd", 100, 2, np.float64)
         for pkg in (jserve, tserve)}

    def both(est, grid_shape=(1, 1), ns=""):
        out = []
        for pkg in (jserve, tserve):
            out.append((pkg.route_for(b[pkg], grid_shape, "cpu", est, ns=ns),
                        pkg.tune_token("hpd", b[pkg], "cpu", ns=ns)))
        return out

    cold = both(1e-3)
    assert cold[0] == cold[1] and cold[1][0][0] == "vmap" \
        and cold[1][1] == ""
    # a cost-model entry: a token, still the batch route
    save(jtc.make_key("cholesky", (128, 128), "float64", (1, 1), "cpu"),
         {"nb": 32}, source="cost_model")
    assert both(1e-3)[0] == both(1e-3)[1]
    # a measured winner on 2x2 beats the estimate: the grid route, and a
    # namespaced one only for its member
    save(jtc.make_key("cholesky", (128, 128), "float64", (2, 2), "cpu"),
         {"nb": 16}, source="measured", metric={"seconds": 1e-4})
    save(jtc.make_key("cholesky", (128, 128), "float64", (1, 1), "cpu",
                      ns="g1"),
         {"nb": 64}, source="measured", metric={"seconds": 5e-4})
    for est, shape, ns in ((1e-3, (2, 2), ""), (1e-5, (2, 2), ""),
                           (None, (2, 2), ""), (1e-3, (1, 1), "g1"),
                           (1e-3, (1, 1), "g0")):
        j, t = both(est, shape, ns)
        assert t == j
    assert both(1e-3, (2, 2))[1][0][0] == "grid"


@pytest.mark.parametrize("op,m", [("lu", None), ("hpd", None),
                                  ("lstsq", 20)])
@pytest.mark.parametrize("dtype,slots", [(np.float64, 8), (np.float64, 1),
                                         (np.float32, 8)])
def test_batch_peak_bytes_within_2x_of_the_jax_liveness_walk(op, m, dtype,
                                                             slots):
    """The buckets of ``tests/serve/test_mem_admission.py`` (n = 12,
    nrhs = 2 -> 16 x 2; lstsq 20 x 12 -> 32 x 16 x 2): the port's closed
    form is at least the JAX figure and at most twice it."""
    for n in (12, 100):
        bj = jserve.make_bucket(op, n, 2, dtype, m=None if m is None
                                else m + n - 12)
        bt = tserve.make_bucket(op, n, 2, dtype, m=None if m is None
                                else m + n - 12)
        pj, pt = j_peak(bj, slots), t_peak(bt, slots)
        assert pj <= pt <= 2 * pj, (bj.key(), slots, pj, pt)


def test_memory_pressure_decisions_equal_across_the_threshold():
    """Budgets around the double-buffered peak: the port sheds exactly
    where its own estimate says (its closed form stands in for the
    liveness walk), with the JAX reject's structure."""
    rng = np.random.default_rng(2)
    A, B = diag_dom(rng, 12), rng.normal(size=(12, 2))
    bt = tserve.make_bucket("lu", 12, 2, np.float64)
    peak = t_peak(bt, 8)
    assert tserve.AdmissionController().bucket_peak_bytes(bt) == peak
    shed = tserve.AdmissionController(hbm_bytes=1.5 * peak).admit("lu", A, B)
    assert shed["reason"] == "memory_pressure"
    assert "double buffer" in shed["detail"]
    ok = tserve.AdmissionController(hbm_bytes=2.5 * peak).admit("lu", A, B)
    assert not isinstance(ok, dict)
    deep = tserve.AdmissionController(hbm_bytes=2.5 * peak,
                                      pipeline_depth=3).admit("lu", A, B)
    assert "pipeline depth 3" in deep["detail"]


def test_capture_gate_excludes_shared_sections():
    """A capture waits for every shared device section to leave and
    holds new ones back; a thread re-enters its shared section past a
    waiting capture; a capture inside a shared section refuses."""
    import threading
    import time
    from elemental_tpu_torch.serve.executor import _CaptureGate
    gate = _CaptureGate()
    log = []
    inside = threading.Event()

    def reader(tag, hold):
        with gate.shared():
            log.append(f"{tag}+")
            inside.set()
            time.sleep(hold)
            with gate.shared():          # re-entry passes the writer
                log.append(f"{tag}~")
            log.append(f"{tag}-")

    def writer():
        with gate.exclusive():
            log.append("W")

    r1 = threading.Thread(target=reader, args=("r1", 0.2))
    r1.start()
    assert inside.wait(timeout=10)
    w = threading.Thread(target=writer)
    w.start()
    time.sleep(0.05)
    r2 = threading.Thread(target=reader, args=("r2", 0.0))
    r2.start()
    for t in (r1, w, r2):
        t.join(timeout=10)
        assert not t.is_alive()
    assert log == ["r1+", "r1~", "r1-", "W", "r2+", "r2~", "r2-"]
    with gate.shared():
        with pytest.raises(RuntimeError):
            with gate.exclusive():
                pass


def test_capture_gate_holder_passes_its_own_sections():
    """The thread that holds the gate exclusive (an escalation) passes
    its own shared and exclusive sections; another thread's shared
    section waits until it leaves."""
    import threading
    from elemental_tpu_torch.serve.executor import _CaptureGate
    gate = _CaptureGate()
    log = []
    started = threading.Event()

    def other():
        started.set()
        with gate.shared():
            log.append("other")

    with gate.exclusive():
        with gate.shared():
            with gate.exclusive():
                log.append("holder")
        t = threading.Thread(target=other)
        t.start()
        assert started.wait(timeout=10)
        t.join(timeout=0.2)
        assert t.is_alive() and log == ["holder"]
    t.join(timeout=10)
    assert not t.is_alive()
    assert log == ["holder", "other"]
