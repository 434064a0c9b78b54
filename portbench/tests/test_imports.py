"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program.  Top-level module names are
compared whole: ``diffdope_tpu_torch`` begins with ``diffdope_tpu``."""

import ast
import os
import subprocess
import sys

from portbench.tests.conftest import ROOT

PKG = ROOT / "portbench"
JAX = {"jax", "jaxlib", "flax", "diffdope_tpu"}


def _imports(path):
    """Top-level names of every module a file imports (relative imports are
    the benchmark's own)."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax():
    for path in PKG.rglob("*.py"):
        assert not (_imports(path) & JAX), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        found = _imports(path)
        assert not (found & (JAX | {"diffdope_tpu_torch"})), (path, found)
        assert found <= {"__future__", "typing", "pathlib", "numpy", "torch", "portbench"}, found


def test_a_run_loads_no_jax():
    """Drive a tiny run on the CPU in a fresh interpreter and list what it
    holds afterwards by whole top-level names."""
    code = (
        "import sys\n"
        "from portbench import run\n"
        "from portbench.tests.conftest import tiny_plan\n"
        "run.run_cell(tiny_plan('tiny-ico', 'near'), 7, 0, False, device='cpu',"
        " window_requests=1, checked=1)\n"
        "print('HELD=' + ','.join(run.forbidden_modules()))\n"
        "print('PROGRAM=%d' % ('diffdope_tpu_torch' in {m.split('.')[0] for m in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert "HELD=" in lines  # nothing of JAX, by whole names
    assert "PROGRAM=1" in lines  # while the program itself ran


def test_the_guard_compares_whole_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "diffdope_tpu_torchlike", sys)
    assert "diffdope_tpu_torchlike" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "diffdope_tpu.render", sys)
    assert run.forbidden_modules() == ["diffdope_tpu.render"]
