"""``python -m elemental_tpu_torch.resilience {abft,certify}`` against the
JAX package's ``perf/abft.py`` and ``perf/certify.py``.

The one JSON line each prints (``abft_report/v1``,
``solve_certificate/v1``) equals the JAX CLI's field by field, clean and
under one ``--fault`` spec, for ``run lu 64 --grid 2x2`` and ``run hpd
--n 64 --nb 16``.  Floats agree to 1e-12 relative, except the
certificates' residuals: those are backward errors of float32 solves,
rounding noise of the working precision, so they agree to 16 float32
eps absolute (the convention of ``tests/test_torch_certify.py``, scaled
to the dtype).  The port's ``smoke`` commands pass on the CPU."""
import functools
import json

import numpy as np
import pytest
import torch

from elemental_tpu_torch.resilience import __main__ as cli

_RESID_ATOL = 16 * np.finfo(np.float32).eps

CASES = [
    ("abft", ["run", "lu", "64", "--grid", "2x2"]),
    ("abft", ["run", "lu", "64", "--grid", "2x2",
              "--fault", "redistribute:scale", "--window", "1:2"]),
    ("abft", ["run", "hpd", "--n", "64", "--nb", "16"]),
    ("abft", ["run", "hpd", "--n", "64", "--nb", "16",
              "--fault", "compute:scale", "--window", "1:2"]),
    ("certify", ["run", "lu", "64", "--grid", "2x2"]),
    ("certify", ["run", "lu", "64", "--grid", "2x2",
                 "--fault", "redistribute:nan:2"]),
    ("certify", ["run", "hpd", "--n", "64", "--nb", "16"]),
    ("certify", ["run", "hpd", "--n", "64", "--nb", "16",
                 "--fault", "panel_spread:nan:0"]),
]


def _last_json(out: str) -> dict:
    lines = [ln for ln in out.strip().split("\n") if ln]
    assert all(ln.startswith("#") for ln in lines[:-1])
    return json.loads(lines[-1])


@functools.cache
def _jax(tool, argv):
    import contextlib
    import io
    from perf import abft, certify
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = {"abft": abft, "certify": certify}[tool].main(list(argv))
    return rc, _last_json(buf.getvalue())


def _same(t, j, path=""):
    """Field by field: floats to 1e-12 relative, residuals as backward
    errors (see the module docstring)."""
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _same(t[k], j[k], f"{path}.{k}")
    elif isinstance(j, list):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _same(a, b, f"{path}[{i}]")
    elif isinstance(j, float) and not isinstance(j, bool):
        if path.endswith(".residual"):
            assert abs(t - j) <= _RESID_ATOL, path
        else:
            assert t == pytest.approx(j, rel=1e-12, abs=0), path
    else:
        assert t == j, path


@pytest.mark.parametrize("tool,argv", CASES,
                         ids=[f"{t}-{'-'.join(a[1:]).replace(':', '_')}"
                              for t, a in CASES])
def test_json_line_equals_the_jax_cli(tool, argv, capsys):
    rc_j, doc_j = _jax(tool, tuple(argv))
    rc_t = cli.main([tool] + argv + ["--device", "cpu"])
    doc_t = _last_json(capsys.readouterr().out)
    assert rc_t == rc_j == 0
    _same(doc_t, doc_j)
    if "--fault" in argv:
        if tool == "abft":
            assert doc_t["violations"] and doc_t["recovered_panels"] == [1]
        else:
            assert doc_t["rung"] != "quant" and doc_t["certified"]


@pytest.mark.parametrize("tool", ["abft", "certify"])
def test_smoke_passes_on_the_cpu(tool, capsys):
    assert cli.main([tool, "smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.strip().endswith(f"# {tool} smoke: ok")


def test_json_flag_prints_only_the_document(capsys):
    assert cli.main(["abft", "run", "qr", "--n", "32", "--nb", "8",
                     "--grid", "1x1", "--json", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().split("\n")
    assert len(out) == 1 and json.loads(out[0])["driver"] == "qr"


def test_without_a_card_the_cli_refuses(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["certify", "run", "lu", "32"]) == 2
    assert cli.main(["abft", "smoke"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_fault_spec_parses_as_the_jax_cli():
    from perf import abft
    for spec in ("redistribute:nan:2", "compute:bitflip",
                 "panel_spread:scale:1:every"):
        t, j = cli._parse_fault(spec), abft._parse_fault(spec)
        assert (t.target, t.kind, t.call, t.every) == \
            (j.target, j.kind, j.call, j.every)
    with pytest.raises(SystemExit):
        cli._parse_fault("redistribute")
