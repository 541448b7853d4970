"""Nothing of the benchmark imports JAX or the JAX package (by whole
top-level name: ``archi_tpu_torch`` begins with ``archi_tpu``), and the
reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from ragbench import run as rb_run
from ragbench.spec import HERE, ROOT

BANNED = {"jax", "jaxlib", "flax", "archi_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _modules():
    for root, _dirs, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_jax_anywhere():
    found = {(os.path.relpath(p, ROOT), m) for p in _modules()
             for m in _imports(p) if m in BANNED}
    assert not found, found


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    found = {(os.path.relpath(p, ROOT), m) for p in _modules()
             if p.startswith(ref + os.sep)
             for m in _imports(p) if m == "archi_tpu_torch"}
    assert not found, found
    assert rb_run.BANNED == ("jax", "jaxlib", "flax", "archi_tpu")


def test_a_dry_run_loads_no_jax():
    """A whole small run in a fresh interpreter, then its modules."""
    code = (
        "import sys, json\n"
        "from ragbench.tests._small import small_cell, run_small\n"
        "from ragbench import run\n"
        "res = run_small(small_cell('trec-covid.hybrid'), seconds=1.0)\n"
        "print(json.dumps({'banned': run.banned_modules(),"
        " 'correct': res['correct']}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-1]
    assert '"banned": []' in last and '"correct": true' in last, last


def test_banned_modules_compares_whole_names(monkeypatch):
    top = {k.split(".")[0] for k in sys.modules}
    monkeypatch.setitem(sys.modules, "archi_tpu_torch_extra", sys)
    assert ("archi_tpu" in rb_run.banned_modules()) == ("archi_tpu" in top)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in rb_run.banned_modules()
