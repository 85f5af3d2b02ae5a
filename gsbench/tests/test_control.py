"""The control, the reference in bfloat16 in the program's place, comes
out not correct by the cells' own limits (at a size a CPU test holds; on
the card at the cells' sizes through ``run.py --control``)."""

import pytest
import torch

from gsbench import harness
from gsbench.reference.compare import judge
from gsbench.tests.tiny import CELLS, tiny_copy


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tmp_path):
    base = tiny_copy(tmp_path)
    wl = harness.load_workload(cell, base)
    cfg = harness.load_config(wl["config"], base)
    entry = harness.load_entry(wl["entry"])
    for seed in (1, 2):
        nums = entry.readings(cfg, wl, seed, torch.device("cpu"), True)
        ok, rows = judge(nums, wl["limits"])
        assert not ok, rows
