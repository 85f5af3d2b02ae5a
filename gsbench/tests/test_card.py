"""Each cell on the card: one short run prints a correct result line.
Run on a machine with a CUDA device:

    python -m pytest gsbench/tests/test_card.py -m card
"""

import json
import subprocess
import sys

import pytest
import torch

from gsbench import harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "gsbench/run.py", "--workload", cell, "--seed",
         "2718281828", "--seconds", "3", "--trace", "0"],
        cwd=harness.repo_root(), capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "gsbench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.repo_root(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
