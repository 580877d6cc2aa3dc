"""What the benchmark may import, and where it refuses to run."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

from pfbench.harness import registry, window

ROOT = registry.ROOT
STACK = set(window.FORBIDDEN)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_the_jax_stack():
    for path in (ROOT / "pfbench").rglob("*.py"):
        assert not STACK.intersection(_imports(path)), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "pfbench" / "reference").rglob("*.py"):
        assert not (STACK | {"posteriflow_torch"}).intersection(
            _imports(path)), path


def _child(code, cwd, extra_env=None):
    env = {**os.environ, "PYTHONPATH": str(cwd), **(extra_env or {})}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_the_reference_loads_no_module_of_the_program():
    code = ("import sys; import pfbench.reference.npe, "
            "pfbench.reference.train, pfbench.reference.long_bns; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "print(sorted(tops & {'posteriflow_torch', 'posteriflow_tpu', "
            "'jax', 'flax'}))")
    proc = _child(code, ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_no_card_no_result():
    """Without a card (this machine) the command exits non-zero and prints
    no result line."""
    proc = subprocess.run([sys.executable, "-m", "pfbench.run", "--workload",
                           "npe_r7.sample", "--seed", str(2**31 + 3),
                           "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_alone_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and pfbench/ the command
    fails and prints no result line."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "pfbench", tmp_path / "pfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    code = ("import sys, runpy; sys.argv = ['pfbench.run', '--workload', "
            "'npe_r7.sample', '--seed', '5', '--seconds', '1', '--trace', "
            "'0']; runpy.run_module('pfbench.run', run_name='__main__')")
    proc = _child(code, tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
