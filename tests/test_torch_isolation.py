"""``elemental_tpu_torch`` and ``chip_smoke.py`` stand alone: importing the
port adds no JAX module and nothing of ``elemental_tpu`` to
``sys.modules``, and no source file of either imports them."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "elemental_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "elemental_tpu"


def test_import_adds_no_jax_or_reference_module():
    code = ("import sys, json; before = set(sys.modules); "
            "import elemental_tpu_torch; "
            "print(json.dumps(sorted(set(sys.modules) - before)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    added = json.loads(out.stdout.strip().splitlines()[-1])
    assert "elemental_tpu_torch" in added
    assert [m for m in added if _forbidden(m)] == []


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_source_imports_no_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert [n for n in names if _forbidden(n)] == []


def test_forbidden_matches_only_the_reference():
    assert _forbidden("jax") and _forbidden("jaxlib.xla_client")
    assert _forbidden("elemental_tpu") and _forbidden("elemental_tpu.kernels")
    assert not _forbidden("elemental_tpu_torch")
    assert not _forbidden("elemental_tpu_torch.kernels.common")


def test_traced_cholesky_and_export_add_no_jax_module(tmp_path):
    """A traced ``cholesky`` on a CPU grid, exported to a Perfetto trace,
    in a fresh interpreter: still no JAX module and nothing of
    ``elemental_tpu``."""
    out = tmp_path / "trace.json"
    code = (
        "import sys, json, numpy as np\n"
        "import elemental_tpu_torch as et\n"
        "from elemental_tpu_torch import obs\n"
        "g = et.Grid(2, 2, device='cpu')\n"
        "F = np.random.default_rng(0).normal(size=(32, 32))\n"
        "A = et.from_global(F @ F.T + 32 * np.eye(32), et.MC, et.MR, g)\n"
        "tr = obs.Tracer()\n"
        "with obs.metrics_scope(), tr:\n"
        "    et.cholesky(A, nb=8, crossover=0, timer=obs.PhaseTimer())\n"
        f"obs.write_json({str(out)!r}, obs.chrome_trace_doc(tr))\n"
        "print(json.dumps([len(tr.phases), sorted(sys.modules)]))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    nphases, mods = json.loads(res.stdout.strip().splitlines()[-1])
    assert nphases > 0 and [m for m in mods if _forbidden(m)] == []
    assert json.loads(out.read_text())["schema"] == "obs_chrome_trace/v1"
