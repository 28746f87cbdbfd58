"""The port's matrix properties (``lapack/props.py``: the determinants,
``two_norm_estimate``, ``condition``, ``inertia``, the Schatten norms)
against ``elemental_tpu``: the inputs of ``tests/lapack/test_props.py``
(made from the same seeds with numpy) go through both packages, the JAX
package once per input on a 1x1 grid and the port on 1x1, 2x2 and 2x4
grids.  Values agree to 1e-12 relative (``safe_determinant``'s kappa, a
mean of logs, to 1e-12 absolute); the counts are equal; every value meets
the JAX tests' own bounds against numpy.  ``two_norm_estimate`` starts
from the JAX package's seeded numpy vector, so the two iterations agree
step for step.

The JAX references run on a 1x1 JAX grid: on its 8 virtual CPU devices a
JAX call that dispatches many small sharded computations in turn can
starve XLA's in-process all-reduce rendezvous when the host is loaded
(several test workers), which aborts the process after 40 s
(``rendezvous.cc``: "Termination timeout ... exceeded"); one device has
no rendezvous.
"""
import functools
import importlib

import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et

jprops = importlib.import_module("elemental_tpu.lapack.props")
tprops = importlib.import_module("elemental_tpu_torch.lapack.props")

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]


def _input(name):
    if name == "general":
        return np.random.default_rng(0).normal(size=(12, 12))
    if name == "scaled":
        return np.random.default_rng(1).normal(size=(10, 10)) * 1e3
    if name == "hpd":
        G = np.random.default_rng(2).normal(size=(12, 12))
        return G @ G.T / 12 + 2 * np.eye(12)
    if name == "cond":
        return np.random.default_rng(3).normal(size=(12, 12))
    if name == "tall":
        return np.random.default_rng(4).normal(size=(16, 10))
    if name == "herm":
        G = np.random.default_rng(5).normal(size=(14, 14))
        return (G + G.T) / 2
    if name == "schatten":
        return np.random.default_rng(6).normal(size=(12, 9))
    raise KeyError(name)


def _jg(F):
    return el.from_global(F, el.MC, el.MR,
                          grid=el.Grid(jax.devices()[:1], height=1))


def _tg(F, rc):
    return et.from_global(F, et.MC, et.MR, grid=et.Grid(*rc, device="cpu"))


def _call(mod, fn, name, dm):
    F = _input(name)
    if fn == "condition_two":
        return mod.condition(dm(F), "two")
    if fn.startswith("condition_"):
        return mod.condition(dm(F), fn.split("_")[1])
    if fn == "two_norm_estimate":
        return mod.two_norm_estimate(dm(F), iters=40)
    if fn == "schatten_norm":
        return mod.schatten_norm(dm(F), 3.0)
    if fn == "inertia":
        return mod.inertia(dm(F), nb=8)
    return getattr(mod, fn)(dm(F))


def _host(x):
    if isinstance(x, tuple):
        return tuple(_host(v) for v in x)
    if isinstance(x, int):
        return x
    return complex(np.asarray(x.cpu() if hasattr(x, "cpu") else x))


@functools.lru_cache(maxsize=None)
def _jax(fn, name):
    return _host(_call(jprops, fn, name, _jg))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_determinant_matches_jax(rc):
    F = _input("general")
    got = _host(tprops.determinant(_tg(F, rc)))
    assert _rel(got, _jax("determinant", "general")) < 1e-12
    ref = np.linalg.det(F)
    assert abs(got - ref) / abs(ref) < 1e-12


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_safe_determinant_matches_jax(rc):
    F = _input("scaled")
    rho, kappa, n = _host(tprops.safe_determinant(_tg(F, rc)))
    jrho, jkappa, jn = _jax("safe_determinant", "scaled")
    assert n == jn == 10
    assert abs(rho - jrho) < 1e-12 and abs(kappa - jkappa) < 1e-12
    sign_ref, logabs_ref = np.linalg.slogdet(F)
    assert abs(rho - sign_ref) < 1e-10
    assert abs(kappa.real * n - logabs_ref) < 1e-8


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_hpd_determinant_matches_jax(rc):
    F = _input("hpd")
    got = _host(tprops.hpd_determinant(_tg(F, rc)))
    assert _rel(got, _jax("hpd_determinant", "hpd")) < 1e-12
    assert abs(got - np.linalg.det(F)) / np.linalg.det(F) < 1e-12


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_two_norm_estimate_matches_jax(rc):
    F = _input("tall")
    got = _host(tprops.two_norm_estimate(_tg(F, rc), iters=40))
    assert _rel(got, _jax("two_norm_estimate", "tall")) < 1e-12
    ref = np.linalg.norm(F, 2)
    assert abs(got - ref) / ref < 1e-6


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_matrix_inertia_matches_jax(rc):
    F = _input("herm")
    got = tprops.inertia(_tg(F, rc), nb=8)
    assert got == _jax("inertia", "herm")
    w = np.linalg.eigvalsh(F)
    assert got[:2] == (int((w > 0).sum()), int((w < 0).sum()))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("p", ["two", "one", "inf", "frob"])
def test_condition_matches_jax(rc, p):
    F = _input("cond")
    got = _host(tprops.condition(_tg(F, rc), p))
    assert _rel(got, _jax(f"condition_{p}", "cond")) < 1e-12
    ref = np.linalg.cond(F, {"two": 2, "one": 1, "inf": np.inf,
                             "frob": "fro"}[p])
    # tests/lapack/test_props.py::test_condition's bound
    assert abs(got - ref) / ref < 1e-10


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
@pytest.mark.parametrize("fn", ["nuclear_norm", "two_norm", "schatten_norm"])
def test_schatten_norms_match_jax(rc, fn):
    F = _input("schatten")
    got = _host(_call(tprops, fn, "schatten", lambda X: _tg(X, rc)))
    assert _rel(got, _jax(fn, "schatten")) < 1e-12
    s = np.linalg.svd(F, compute_uv=False)
    # tests/lapack/test_props.py::test_schatten_norms' bounds
    ref, bound = {"nuclear_norm": (s.sum(), 1e-10),
                  "two_norm": (s[0], 1e-11),
                  "schatten_norm": ((s ** 3).sum() ** (1 / 3), 1e-10)}[fn]
    assert abs(got - ref) < bound


def test_perm_sign_matches_jax():
    rng = np.random.default_rng(7)
    for n in (1, 2, 5, 12):
        for _ in range(5):
            p = rng.permutation(n)
            assert tprops._perm_sign(p) == jprops._perm_sign(p) \
                == np.linalg.det(np.eye(n)[p])
