"""Driver call-count parity: for every comm-plan golden (the ``*_abft``
ones of the checksum-guarded drivers included), the port's
``redist_trace`` label counts of the same call on the same grid equal
the ``redistributes`` map of the JAX package's live trace of that call (``analysis.drivers.trace_driver``,
which traces under ``jax.make_jaxpr`` and runs no collective).

The live trace, not the golden file, is the reference: where a golden's
map disagrees with it, that is a finding of the JAX package
(ROADMAP section 3), and the golden stays as it is."""
import functools
import json
import pathlib
from collections import Counter

import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.analysis.drivers import (DEFAULT_N, DEFAULT_NB, DRIVERS,
                                            trace_driver)
from elemental_tpu_torch.redist import engine as t_engine

GOLDEN = pathlib.Path(__file__).parent / "golden" / "comm_plans"
NAMES = sorted({p.name.split("__")[0] for p in GOLDEN.glob("*.json")})
GRIDS = [(1, 1), (2, 2)]


@functools.cache
def _jax_labels(name, rc):
    grid = el.Grid(jax.devices()[: rc[0] * rc[1]], height=rc[0])
    _, _, log = trace_driver(name, grid)
    return Counter(rec.label for rec in log)


def _mat(n, m=None, kind="gen", seed=0):
    rng = np.random.default_rng(seed)
    m = n if m is None else m
    F = rng.normal(size=(n, m)).astype(np.float32)
    if kind == "hpd":
        F = (F @ F.T + n * np.eye(n)).astype(np.float32)
    elif kind == "tri":
        F = (np.tril(F) + n * np.eye(n)).astype(np.float32)
    return F


def _port_call(name, rc):
    """Run the port's twin of registered driver ``name`` on an r x c CPU
    grid at the registry's trace geometry (n = 64, nb = 16, float32)."""
    n, nb = DEFAULT_N, DEFAULT_NB
    g = et.Grid(*rc, device="cpu")
    meta = DRIVERS[name].build(el.Grid(jax.devices()[:1]), n, nb,
                               np.float32)[2]
    rp = meta.get("redist_path")

    def dm(F):
        return et.from_global(F, et.MC, et.MR, g)

    if name.startswith("gemm_slice"):
        m, k, n2 = meta["extents"]
        return et.gemm(dm(_mat(m, k)), dm(_mat(k, n2, seed=1)), alg="slice",
                       nb=nb)
    if name.startswith("gemm_"):
        return et.gemm(dm(_mat(n)), dm(_mat(n, seed=1)), alg=meta["alg"],
                       nb=nb, redist_path=rp)
    if name.startswith("trsm"):
        return et.trsm(meta.get("side", "L"), "L", "N", dm(_mat(n, kind="tri")),
                       dm(_mat(n, seed=1)), nb=nb, redist_path=rp)
    if name.startswith("herk"):
        return et.herk("L", dm(_mat(n)), nb=nb, redist_path=rp)
    if name.startswith("cholesky"):
        return et.cholesky(dm(_mat(n, kind="hpd")), nb=nb,
                           lookahead=meta["lookahead"],
                           crossover=meta["crossover"],
                           comm_precision=meta["comm_precision"],
                           abft=meta["abft"] or None)
    if name.startswith("lu"):
        return et.lu(dm(_mat(n)), nb=nb, lookahead=meta["lookahead"],
                     crossover=meta["crossover"], panel=meta["panel"],
                     comm_precision=meta["comm_precision"],
                     abft=meta["abft"] or None)
    if name.startswith("qr_lq"):
        return et.lq(dm(_mat(n)), nb=nb, redist_path=rp)
    if name.startswith("qr"):
        return et.qr(dm(_mat(n)), nb=nb, panel=meta["panel"],
                     abft=meta.get("abft") or None)
    if name.startswith("redist_md"):
        m_, n_ = meta["extents"]
        B = et.redistribute(dm(_mat(m_, n_)), et.MD, et.STAR, path=rp)
        return et.redistribute(B, et.STAR, et.MD, path=rp)
    if name.startswith("redist_circ"):
        B = et.redistribute(dm(_mat(n)), et.CIRC, et.CIRC)
        return et.redistribute(B, et.VC, et.STAR)
    raise KeyError(name)


def test_every_golden_driver_has_a_port_twin():
    assert NAMES and set(NAMES) <= set(DRIVERS)
    assert {"lu_abft", "cholesky_abft", "qr_abft"} <= set(NAMES)


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_port_counts_equal_the_live_jax_trace(name, rc):
    want = _jax_labels(name, rc)
    with t_engine.redist_trace() as log:
        _port_call(name, rc)
    assert Counter(rec.label for rec in log) == want


@pytest.mark.parametrize("name", ["lu_calu", "cholesky_lookahead_commq",
                                  "qr_tsqr"])
def test_golden_maps_that_agree_with_the_live_trace(name):
    """The goldens of this slice's new paths agree with the live trace on
    both grids (so the port, held to the live trace, matches them too)."""
    for rc in GRIDS:
        doc = json.loads((GOLDEN / f"{name}__{rc[0]}x{rc[1]}.json").read_text())
        assert Counter(doc["redistributes"]) == _jax_labels(name, rc)
