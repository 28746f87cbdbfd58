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
