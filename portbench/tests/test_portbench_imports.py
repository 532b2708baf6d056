"""What the benchmark loads: never JAX nor the JAX package, and its
reference nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _python(code: str, cwd=ROOT, path=f"{ROOT}{os.pathsep}{ROOT / 'src'}"
            ) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=path)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_harness_reference_and_readers_load_no_jax():
    code = f"""
import json, sys
from pathlib import Path
import portbench.control, portbench.harness, portbench.verify
import portbench.generators.s51, portbench.generators.tpch
from portbench.harness import _module, reader
for p in sorted(Path({str(BENCH)!r}, "metrics").glob("*.py")):
    reader(Path({str(BENCH)!r}), p.stem)
for p in sorted(Path({str(BENCH)!r}, "traffic").glob("*.py")):
    _module(Path({str(BENCH)!r}), "traffic", p.stem)
import repro_torch.runtime.join_serve, repro_torch.kernels.ops
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert "portbench" in top and "repro_torch" in top
    assert not top & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    out = _python("import sys, portbench.reference.join, portbench.verify, "
                  "portbench.yardstick, portbench.generators.s51, "
                  "portbench.generators.tpch; "
                  "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert out.returncode == 0, out.stderr
    assert "repro_torch" not in out.stdout and "'repro'" not in out.stdout
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            assert not {n.split(".")[0] for n in names} & (
                FORBIDDEN | {"repro_torch"}), (path, names)


def test_the_command_refuses_a_machine_without_enough_cards():
    """Without a card the command exits non-zero and prints no result."""
    code = ("import runpy, sys, torch; "
            "torch.cuda.is_available = lambda: False; "
            f"sys.argv = ['run.py', '--workload', 's51-dash-error', "
            f"'--seed', '3000000001', '--seconds', '1', '--trace', '0']; "
            f"runpy.run_path({str(BENCH / 'run.py')!r}, run_name='__main__')")
    out = _python(code)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_the_command_fails_beside_nothing_but_the_benchmark(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the command exits non-zero and prints no result, card or none."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import runpy, sys, torch; "
            "torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "sys.argv = ['run.py', '--workload', 's51-dash-error', "
            "'--seed', '3000000001', '--seconds', '1', '--trace', '0']; "
            "runpy.run_path('portbench/run.py', run_name='__main__')")
    out = _python(code, cwd=tmp_path, path="")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "repro_torch" in out.stderr
