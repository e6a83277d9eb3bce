"""No JAX in a benchmark process, and a reference that owes nothing to the
program."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import bench_small as bs

REHEARSAL = """
import json, sys
sys.path[:0] = [{tests!r}]
import bench_small as bs
from benchlib.harness import banned_modules
outs = [bs.run("knot-kan1-bulk"), bs.run("qwen25-kanffn-rag"),
        bs.run("qwen25-kanffn-reason", trace=True)]
print(json.dumps({{"banned": banned_modules(),
                   "modules": sorted({{n.split(".")[0] for n in sys.modules}}),
                   "correct": [o["correct"] for o in outs]}}))
"""


def test_cpu_rehearsal_loads_no_jax_nor_the_jax_package():
    code = REHEARSAL.format(tests=str(bs.BENCH / "tests"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=bs.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["banned"] == [] and out["correct"] == [True, True, True]
    for name in ("jax", "jaxlib", "flax", "repro"):
        assert name not in out["modules"]
    assert "repro_torch" in out["modules"]


def imported_roots(path) -> set:
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_bench_file_imports_jax_or_the_jax_package():
    for path in bs.BENCH.rglob("*.py"):
        roots = imported_roots(path)
        assert not roots & {"jax", "jaxlib", "flax", "repro"}, path
        assert "benchmarks" not in roots, path


def test_the_references_import_nothing_of_the_program():
    for path in (bs.BENCH / "reference").glob("*.py"):
        assert "repro_torch" not in imported_roots(path), path
    code = ("import sys; sys.path[:0] = [{b!r}]\n"
            "from benchlib.manifest import load_reference\n"
            "load_reference('kan_network'); load_reference('qwen2_kanffn')\n"
            "print(sorted({{n.split('.')[0] for n in sys.modules}}))"
            ).format(b=str(bs.BENCH))
    res = subprocess.run([sys.executable, "-c", code], cwd=bs.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "repro_torch" not in res.stdout and "'repro'" not in res.stdout
