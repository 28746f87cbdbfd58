"""The port's example twins (``elemental_tpu_torch.examples``) as a smoke
suite, held to the JAX examples.

Each twin runs on the CPU on a virtual 2x4 grid (``--device cpu --ranks
8``, the JAX test's 8 virtual devices) at ``tests/test_examples.py``'s
argv, under that test's checks: every listed key below 1e-3, and
``converged=True`` where the example reports it.  Then the JAX script
runs at the same argv and the two reports must agree: every input is made
with numpy from the same seeds in both packages, so ``iters`` and the
integer keys are equal, and each float key is within 10x of the JAX
value or both are below 1e-10.  ``rpca`` and ``pseudospectra`` take the
JAX comparison in the slow tier only, as ``tests/test_examples.py`` runs
those two scripts.
"""
import os
import runpy
import sys

import pytest

from elemental_tpu_torch.examples._common import EXAMPLES, parse_reports

_EX = os.path.join(os.path.dirname(__file__), os.pardir, "examples")

#: (module, the JAX test's argv, the keys it checks)
_CASES = [
    ("cholesky", ["--n", "96"], ["factor_resid", "solve_resid"]),
    ("lu", ["--n", "96"], ["factor_resid"]),
    ("qr_least_squares", ["--m", "120", "--n", "40"], ["lstsq_err"]),
    ("herm_eig", ["--n", "80"], ["resid", "orth"]),
    ("svd", ["--m", "90", "--n", "40"], ["reconstruct", "sv_err"]),
    ("lp", ["--m", "10", "--n", "24"], ["rel_gap"]),
    ("lav", ["--m", "120", "--n", "20", "--nnz", "800"], ["recovery_err"]),
    ("rpca", ["--m", "40", "--n", "40", "--rank", "2"], ["recovery_err"]),
    ("pseudospectra", ["--n", "40", "--npts", "6"], []),
    ("spd_scaling_sweep", ["--n", "64"], ["resid"]),
]

#: the two whose JAX scripts ride the slow tier (tests/test_examples.py)
_SLOW_JAX = {"rpca", "pseudospectra"}

#: keys that hold no measurement: equal in both reports
_EXACT = {"n", "m", "rank", "npts", "grid", "converged", "iters"}


def _run(run, argv, capsys) -> str:
    old = sys.argv
    sys.argv = ["example"] + argv
    try:
        run()
    finally:
        sys.argv = old
    return capsys.readouterr().out


def _port(name, argv, capsys) -> list:
    out = _run(lambda: runpy.run_module(
        f"elemental_tpu_torch.examples.{name}", run_name="__main__"),
        argv + ["--device", "cpu", "--ranks", "8"], capsys)
    reports = parse_reports(out)
    assert reports, out
    return reports


def _jax(name, argv, capsys) -> list:
    sys.path.insert(0, _EX)
    try:
        out = _run(lambda: runpy.run_path(os.path.join(_EX, f"{name}.py"),
                                          run_name="__main__"), argv, capsys)
    finally:
        sys.path.remove(_EX)
    return parse_reports(out)


def test_cases_cover_every_example():
    assert sorted(c[0] for c in _CASES) == sorted(EXAMPLES)


@pytest.mark.parametrize("name,argv,metrics", _CASES, ids=[c[0] for c in _CASES])
def test_example_twin(name, argv, metrics, capsys):
    for _, rep in _port(name, argv, capsys):
        for key in metrics:
            assert abs(float(rep[key])) < 1e-3, (name, key, rep)
        if "converged" in rep:
            assert rep["converged"] == "True", (name, rep)


@pytest.mark.parametrize(
    "name,argv", [pytest.param(c[0], c[1], id=c[0],
                               marks=(pytest.mark.slow,)
                               if c[0] in _SLOW_JAX else ())
                  for c in _CASES])
def test_example_twin_agrees_with_jax(name, argv, capsys):
    port = _port(name, argv, capsys)
    ref = _jax(name, argv, capsys)
    assert [n for n, _ in port] == [n for n, _ in ref], (port, ref)
    for (_, p), (_, j) in zip(port, ref):
        assert set(p) == set(j), (name, p, j)
        for key in p:
            if key in _EXACT:
                assert p[key] == j[key], (name, key, p, j)
                continue
            a, b = abs(float(p[key])), abs(float(j[key]))
            if key in ("w_min", "w_max", "sigmin_min", "sigmin_max"):
                # eigenvalues and singular values of one matrix
                assert a == pytest.approx(b, rel=1e-9, abs=1e-12), (key, p, j)
            else:
                assert (a < 1e-10 and b < 1e-10) or b / 10 <= a <= 10 * b, \
                    (name, key, p, j)
