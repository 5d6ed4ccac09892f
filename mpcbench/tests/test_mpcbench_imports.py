"""Nothing the benchmark runs holds JAX or the JAX package, and the
reference holds nothing of the program; top-level module names are
compared whole (the program's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from mpcbench_cells import ROOT

JAX = {"jax", "jaxlib", "flax", "intent_mpc_tpu"}

SETUP = """
import json, sys, torch
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from mpcbench_cells import tiny_cell, tiny_args
from mpcbench import run as R
c = tiny_cell("dynus200-fused.rt32")
res, _ = R.run_cell(c, tiny_args("dynus200-fused.rt32", seconds=0.5), torch.device("cpu"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_cell_run_imports_no_jax():
    code = SETUP.format(root=ROOT, tests=os.path.join(ROOT, "mpcbench", "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "intent_mpc_torch" in top and not (top & JAX)


def test_run_checks_the_same_names():
    from mpcbench import run as R
    assert set(R.FORBIDDEN) == JAX


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r);"
            "import mpcbench.reference.cycle, mpcbench.reference.solve;"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout))
    assert not (top & (JAX | {"intent_mpc_torch"}))
    ref = os.path.join(ROOT, "mpcbench", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, name)).read())
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module]
                for m in mods:
                    assert m.split(".")[0] in {"math", "typing", "numpy", "torch",
                                                "__future__"}, (name, m)


@pytest.mark.parametrize("kind", ["stages", "maps"])
def test_stages_and_maps_import_nothing_of_the_program(kind):
    """A configuration's check stages and maps are the benchmark's own, as
    the reference is: loaded, they bring in nothing of the program."""
    code = ("import sys, os, json; sys.path.insert(0, %r);"
            "from mpcbench import harness as hz;"
            "[hz.load_module(%r, n[:-3]) for n in os.listdir(os.path.join(hz.HERE, %r))"
            " if n.endswith('.py')];"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % (ROOT, kind, kind))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert not (set(json.loads(out.stdout)) & (JAX | {"intent_mpc_torch"}))
    d = os.path.join(ROOT, "mpcbench", kind)
    for name in os.listdir(d):
        if name.endswith(".py"):
            for node in ast.walk(ast.parse(open(os.path.join(d, name)).read())):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module]
                for m in mods:
                    assert m.split(".")[0] in {"math", "typing", "numpy", "torch",
                                                "__future__", "mpcbench"}, (name, m)
