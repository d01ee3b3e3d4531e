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
           "repro_torch.data.design", "repro_torch.data.synthetic",
           "repro_torch.serve", "repro_torch.serve.engine",
           "repro_torch.timing", "repro_torch.kernels.stats_gram_solve",
           "repro_torch.kernels.margin_ls", "repro_torch.kernels.predict_tile",
           "repro_torch.checkpoint", "repro_torch.glm",
           "repro_torch.launch.serve_glm", "repro_torch.io",
           "repro_torch.io.hashing", "repro_torch.io.libsvm",
           "repro_torch.io.parquet", "repro_torch.io.prefetch",
           "repro_torch.data.pipeline", "repro_torch.launch.ingest_train",
           "repro_torch.obs", "repro_torch.obs.trace",
           "repro_torch.obs.metrics", "repro_torch.obs.convergence",
           "repro_torch.launch.trace_report", "repro_torch.dist",
           "repro_torch.dist.bootstrap", "repro_torch.dist.faults",
           "repro_torch.dist.launcher", "repro_torch.dist.telemetry",
           "repro_torch.core.alb", "repro_torch.sharding",
           "repro_torch.sharding.compress",
           "repro_torch.sharding.collectives",
           "repro_torch.launch.dist_run"]


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


def test_enabled_tracer_leaves_jax_and_repro_out(tmp_path):
    """Tracing on (``REPRO_TRACE`` at import) and a traced CPU fit with its
    stream, a span and a report: still no jax and nothing of repro."""
    code = ("import sys, json, numpy as np\n"
            "from repro_torch.obs import trace\n"
            "from repro_torch.core.solver import GLMSolver\n"
            "from repro_torch.launch import trace_report\n"
            "assert trace.get_tracer().enabled\n"
            "X = np.eye(16, 8, dtype=np.float32)\n"
            "y = np.where(np.arange(16) % 2, 1.0, -1.0).astype(np.float32)\n"
            "s = GLMSolver(X, y, device='cpu')\n"
            "s.fit(lam1=0.01, max_outer=2)\n"
            "trace.get_tracer().save()\n"
            "assert trace_report.main([sys.argv[1]]) == 0\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(json.dumps(bad))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               REPRO_TRACE=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert list(tmp_path.glob("convergence_*.jsonl"))


def test_mesh_fit_leaves_jax_and_repro_out():
    """A (1, 1) mesh fit in a world of one (gloo on the CPU), its
    collectives and a gathered beta: no jax and nothing of repro."""
    code = ("import sys, json, numpy as np\n"
            "from repro_torch.dist import bootstrap\n"
            "from repro_torch.core.solver import GLMSolver\n"
            "bootstrap.initialize(device='cpu', backend='gloo')\n"
            "mesh = bootstrap.make_dist_mesh(1, 1)\n"
            "X = np.eye(16, 8, dtype=np.float32)\n"
            "y = np.where(np.arange(16) % 2, 1.0, -1.0).astype(np.float32)\n"
            "s = GLMSolver(X, y, mesh=mesh, device='cpu')\n"
            "s.fit(lam1=0.01, max_outer=2)\n"
            "bootstrap.shutdown()\n"
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
