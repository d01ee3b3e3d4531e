"""repro_torch stands alone: importing it pulls in neither jax nor any module
of the JAX package, and no source of the port (nor chip_smoke.py) imports
them."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
MODULES = ["repro_torch", "repro_torch.convert", "repro_torch.core.solver",
           "repro_torch.core.dglmnet", "repro_torch.kernels.ops",
           "repro_torch.data.design", "repro_torch.data.synthetic"]


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "profile_superstep.py"]


@pytest.mark.parametrize("module", MODULES)
def test_import_leaves_jax_and_repro_out(module):
    code = (f"import sys, json, {module}\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(json.dumps(bad))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_imports_in_the_port(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"
