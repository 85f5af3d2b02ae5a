"""What a run loads: no module whose top-level name is jax, jaxlib, flax
or grendel_tpu, compared whole (the port's name begins with the JAX
package's); and the reference imports nothing of the program."""

import ast
import subprocess
import sys

from gsbench import harness

ROOT = harness.repo_root()


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_forbidden_is_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "grendel_tpu_torch_like", object())
    assert "grendel_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "grendel_tpu.ops", object())
    assert "grendel_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    code = f"""
import sys, time, tempfile, torch
from pathlib import Path
sys.path.insert(0, {str(ROOT)!r})
from gsbench import harness, run
from gsbench.tests.tiny import tiny_copy
with tempfile.TemporaryDirectory() as d:
    base = tiny_copy(Path(d))
    for cell in ("garden4k-train", "garden4k-render"):
        run.run_cell(cell, 3, 2.0, False, torch.device("cpu"),
                     time.perf_counter(), base=base)
for name in harness.load_benchmark()["per_layer"]:
    harness.load_metric(name["name"])
import gsbench.entries.trainer_loop
import grendel_tpu_torch.scripts.train, grendel_tpu_torch.engine.trainer_dist
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    top = _loaded(code)
    assert "grendel_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in ("grendel_tpu_torch",
                                               "grendel_tpu", "jax"), path
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import gsbench.reference.render, gsbench.reference.step
import gsbench.reference.compare
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    assert "grendel_tpu_torch" not in _loaded(code)
