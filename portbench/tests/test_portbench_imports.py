"""What a run loads: no module of JAX or of the JAX package in any cell, and
nothing of the program in the reference."""

import ast
import os
import subprocess
import sys

import pytest

from portbench.harness import FORBIDDEN_MODULES, PKG, ROOT
from portbench.tests import tiny

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from portbench.tests import tiny
from portbench import run
from portbench.harness import benchmark, limits_path, load_json
wl = {workload!r}
run.run_cell(benchmark(), tiny.cell(wl), tiny.config_for(wl), tiny.traffic(wl),
             load_json(limits_path(wl)), tiny.SEED, 0.5, {trace}, torch.device("cpu"))
print(json.dumps(sorted({{m.split(".", 1)[0] for m in list(sys.modules)}})))
"""


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", tiny.WORKLOADS)
def test_a_run_loads_no_jax(workload, trace):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT, workload=workload,
                                                             trace=trace)],
                         capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "videollamb_torch" in top
    assert not top & set(FORBIDDEN_MODULES), top & set(FORBIDDEN_MODULES)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(PKG, "reference")
    for name in sorted(os.listdir(ref)):
        if name.endswith(".py"):
            for mod in _imports(os.path.join(ref, name)):
                top = mod.split(".", 1)[0]
                assert top not in ("videollamb_torch",) + FORBIDDEN_MODULES, (name, mod)
                assert top in ("portbench", "torch", "math", "dataclasses", "typing",
                               "__future__"), (name, mod)
                assert not mod.startswith("portbench.") or mod.startswith("portbench.reference"), \
                    (name, mod)
    probe = ("import sys; sys.path.insert(0, %r); import portbench.reference.videollamb, "
             "portbench.reference.languagebind; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] == 'videollamb_torch'))" % ROOT)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr


def test_no_result_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, a run
    exits with another code than 0 and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          tiny.WORKLOADS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
