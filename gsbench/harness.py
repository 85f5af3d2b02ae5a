"""Finds a cell's pieces by name, runs it, and assembles its result line.

Everything that belongs to one configuration, cell or per-layer metric is
a file of its own, found by the name ``BENCHMARK.json`` gives it:

  * ``configs/<config>.json``: the configuration's sizes;
  * ``workloads/<cell>.json``: the cell: its configuration, the entry its
    window drives (``entries/<entry>.py``), its traffic and its limits;
  * ``metrics/<metric>.py``: a per-layer metric's reader: ``LAYER``,
    ``UNIT`` and ``read(evidence)``, which returns a number or None where
    it finds nothing to read. A metric split by the end-to-end metric it
    moves (``step_mfu.train``, ``step_mfu.loop``) is read by the one file
    of its first part (``metrics/step_mfu.py``) unless a file has its
    whole name; which cells report it, and what it moves, is
    ``BENCHMARK.json``'s.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "grendel_tpu")


def repo_root(base: Path = HERE) -> Path:
    return base.parent


def load_benchmark(base: Path = HERE) -> dict:
    return json.loads((repo_root(base) / "BENCHMARK.json").read_text())


def load_config(name: str, base: Path = HERE) -> dict:
    return json.loads((base / "configs" / f"{name}.json").read_text())


def load_workload(name: str, base: Path = HERE) -> dict:
    return json.loads((base / "workloads" / f"{name}.json").read_text())


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_file(name: str, base: Path = HERE) -> Path:
    """The reader of the per-layer metric ``name``: ``metrics/<name>.py``,
    else the file of the name's first part."""
    whole = base / "metrics" / f"{name}.py"
    return whole if whole.exists() else \
        base / "metrics" / f"{name.split('.')[0]}.py"


def load_metric(name: str, base: Path = HERE):
    return _load_file(metric_file(name, base),
                      "gsbench_metric_" + name.replace(".", "_").replace("-", "_"))


def load_entry(name: str):
    """An entry is code: ``gsbench/entries/<name>.py``, a module of the
    package."""
    return importlib.import_module(f"gsbench.entries.{name}")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports."""
    return [m for m in bench[kind] if applies(m, cell)]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values`` (linear between ranks)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
