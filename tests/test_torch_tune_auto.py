"""'auto' through the port's drivers, against the JAX package's 'auto'
calls: every tunable driver accepts 'auto' on 1x1 and 2x2 grids, resolves
from the cost model on an empty cache (nothing run on a card), and agrees
with the JAX package's 'auto' result to 1e-12 in float64 -- the two
tuners pick the same knobs.  The probes behind the cost model leave the
caller's counters, traces, observers and fault plan untouched."""
import functools

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu_torch.redist import engine as t_engine

N = 24


@functools.cache
def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


@pytest.fixture(params=[(1, 1), (2, 2)], ids=["grid1x1", "grid2x2"])
def rc(request, tmp_path, monkeypatch):
    """1x1 and 2x2 grids with EMPTY caches for both packages."""
    from elemental_tpu.tune import cache as jc, policy as jp
    from elemental_tpu_torch.tune import cache as tc, policy as tp
    monkeypatch.setenv(jc.ENV_DIR, str(tmp_path / "jax"))
    monkeypatch.setenv(tc.ENV_DIR, str(tmp_path / "torch"))
    jp._RESOLVE_MEMO.clear()
    tp.clear_memo()
    yield request.param
    jp._RESOLVE_MEMO.clear()
    tp.clear_memo()


def _both(F, rc):
    return (el.from_global(F, el.MC, el.MR, jgrid(*rc)),
            et.from_global(F, et.MC, et.MR, et.Grid(*rc, device="cpu")))


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _g(x):
    return et.to_global(x).numpy()


def _jg(x):
    return np.asarray(el.to_global(x))


def _rng(seed):
    return np.random.default_rng(seed)


def test_cholesky_auto(rc):
    G = _rng(0).normal(size=(N, N))
    S = G @ G.T + N * np.eye(N)
    jA, tA = _both(S, rc)
    kw = dict(nb="auto", lookahead="auto", crossover="auto",
              panel_impl="auto")
    L = et.cholesky(tA, **kw)
    _close(np.tril(_g(L)), np.tril(_jg(el.cholesky(jA, **kw))))


def test_lu_auto(rc):
    F = _rng(1).normal(size=(N, N))
    jA, tA = _both(F, rc)
    kw = dict(nb="auto", lookahead="auto", crossover="auto", panel="auto")
    LU, perm = et.lu(tA, **kw)
    jLU, jperm = el.lu(jA, **kw)
    assert np.array_equal(perm.numpy(), np.asarray(jperm))
    _close(_g(LU), _jg(jLU))


def test_qr_auto(rc):
    F = _rng(2).normal(size=(N, 16))
    jA, tA = _both(F, rc)
    Ap, tau = et.qr(tA, nb="auto", panel="auto")
    jAp, jtau = el.qr(jA, nb="auto", panel="auto")
    assert Ap._qr_nb == jAp._qr_nb and isinstance(Ap._qr_nb, int)
    _close(np.abs(np.triu(_g(Ap))[:16]), np.abs(np.triu(_jg(jAp))[:16]))
    # apply_q with the recorded default and with nb='auto' (resolved to
    # the same block size) round-trips B
    B = _rng(3).normal(size=(N, 4))
    jB, tB = _both(B, rc)
    out = et.apply_q(Ap, tau, et.apply_q(Ap, tau, tB, orient="C", nb="auto"))
    _close(_g(out), B, 1e-10)


def test_gemm_auto(rc):
    A, B = _rng(3).normal(size=(N, 32)), _rng(4).normal(size=(32, 20))
    (jA, tA), (jB, tB) = _both(A, rc), _both(B, rc)
    C = et.gemm(tA, tB, alg="auto", nb="auto")
    _close(_g(C), _jg(el.gemm(jA, jB, alg="auto", nb="auto")))
    _close(_g(C), A @ B)


def test_trsm_auto(rc):
    A = np.tril(_rng(4).normal(size=(N, N))) + N * np.eye(N)
    B = _rng(5).normal(size=(N, 8))
    (jA, tA), (jB, tB) = _both(A, rc), _both(B, rc)
    X = et.trsm("L", "L", "N", tA, tB, nb="auto", comm_precision="auto",
                redist_path="auto")
    _close(_g(X), _jg(el.trsm("L", "L", "N", jA, jB, nb="auto",
                              comm_precision="auto", redist_path="auto")))


def test_herk_auto(rc):
    A = _rng(5).normal(size=(N, 32))
    jA, tA = _both(A, rc)
    C = et.herk("L", tA, nb="auto", redist_path="auto")
    _close(np.tril(_g(C)), np.tril(_jg(el.herk("L", jA, nb="auto",
                                               redist_path="auto"))))


def test_solves_pass_auto_through(rc):
    """hpd_solve / lu_solve / least_squares hand nb='auto' to the factor
    and to the sweeps (resolved as op 'trsm'), as in the JAX package."""
    G = _rng(6).normal(size=(N, N))
    S = G @ G.T + N * np.eye(N)
    B = _rng(7).normal(size=(N, 3))
    (jS, tS), (jB, tB) = _both(S, rc), _both(B, rc)
    _close(_g(et.hpd_solve(tS, tB, nb="auto")),
           _jg(el.hpd_solve(jS, jB, nb="auto")))
    F = _rng(8).normal(size=(N, N))
    jF, tF = _both(F, rc)
    _close(_g(et.lu_solve(tF, tB, nb="auto", panel="auto")),
           _jg(el.lu_solve(jF, jB, nb="auto", panel="auto")))
    T = _rng(9).normal(size=(N, 12))
    jT, tT = _both(T, rc)
    _close(_g(et.least_squares(tT, tB, nb="auto")),
           _jg(el.least_squares(jT, jB, nb="auto")))


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_gemm_with_its_defaults_returns_the_product(shape, tmp_path,
                                                    monkeypatch):
    from elemental_tpu_torch.tune import cache as tc, policy as tp
    monkeypatch.setenv(tc.ENV_DIR, str(tmp_path))
    tp.clear_memo()
    A, B = _rng(10).normal(size=(20, 12)), _rng(11).normal(size=(12, 16))
    g = et.Grid(*shape, device="cpu")
    C = et.gemm(et.from_global(A, et.MC, et.MR, g),
                et.from_global(B, et.MC, et.MR, g))
    _close(_g(C), A @ B)


def test_auto_resolution_is_cost_model_cold(rc):
    res = et.tune.resolve("lu", gshape=(N, N), dtype=torch.float32,
                          grid=et.Grid(*rc, device="cpu"),
                          requested={"nb": "auto", "lookahead": "auto",
                                     "crossover": "auto"})
    assert res.source == "cost_model"
    assert isinstance(res.config["nb"], int) and res.config["nb"] >= 1
    assert isinstance(res.config["lookahead"], bool)
    assert isinstance(res.config["crossover"], int)
    assert res.scores


def test_unresolved_auto_is_a_driver_bug():
    with pytest.raises(TypeError):
        et.tune.blocksize_policy("auto", 2, 64)


@pytest.mark.parametrize("op", ["cholesky", "lu", "qr", "trsm", "herk"])
def test_the_probe_does_not_leak(op, tmp_path, monkeypatch):
    """A driver call with 'auto', made inside ``redist_counts()`` and
    ``redist_trace()`` with an observer and a fault plan installed,
    records exactly what the same call with the resolved explicit knobs
    records: the cost model's probes are unseen."""
    from elemental_tpu_torch.tune import cache as tc, policy as tp
    monkeypatch.setenv(tc.ENV_DIR, str(tmp_path))

    class CountingPlan:
        """A fault plan that corrupts nothing and counts what it sees."""
        def __init__(self):
            self.seen = 0

        def apply(self, target, outputs):
            self.seen += 1
            return outputs

    g = et.Grid(2, 2, device="cpu")
    F = _rng(12).normal(size=(N, N))
    S = F @ F.T + N * np.eye(N)
    A = et.from_global(S if op == "cholesky" else F, et.MC, et.MR, g)
    Bm = et.from_global(_rng(13).normal(size=(N, 4)), et.MC, et.MR, g)
    knobs = {"cholesky": ["nb", "lookahead", "crossover"],
             "lu": ["nb", "lookahead", "crossover", "panel"],
             "qr": ["nb", "panel"], "trsm": ["nb"], "herk": ["nb"]}[op]

    def call(**kw):
        if op == "cholesky":
            return et.cholesky(A, **kw)
        if op == "lu":
            return et.lu(A, **kw)
        if op == "qr":
            return et.qr(A, **kw)
        if op == "trsm":
            return et.trsm("L", "L", "N", A, Bm, **kw)
        return et.herk("L", A, **kw)

    def recorded(**kw):
        seen = []
        remove = t_engine.add_redist_observer(seen.append)
        try:
            with t_engine.redist_counts() as cnt, \
                    t_engine.redist_trace() as log, \
                    t_engine.fault_injection(CountingPlan()) as fp:
                call(**kw)
        finally:
            remove()
        return (dict(cnt), [(r.label, r.rounds, r.wire_bytes) for r in log],
                len(seen), fp.seen)

    tp.clear_memo()
    auto = recorded(**{k: "auto" for k in knobs})
    kn = tp._RESOLVE_MEMO and next(iter(tp._RESOLVE_MEMO.values())).config
    assert kn and set(kn) == set(knobs)
    explicit = recorded(**kn)
    assert auto == explicit
    assert auto[0], "the call itself is still counted"
