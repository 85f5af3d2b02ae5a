"""The multi-rank training loop's other paths, on 2 gloo ranks on the CPU,
in short runs of __graft_entry__.py's scene (8 iterations at bsz 2, one
densify round after the 4th step; see tests/test_torch_trainer_dist.py):

  * whole-image division (``image_distribution`` off) and
    ``local_sampling`` (each rank draws from its own cameras, ``uid % 2``),
    against grendel_tpu's 2-device ``Trainer`` (both with the preload
    threshold at 0, so neither switches ``local_sampling`` off; JAX's
    ground truth packed on the host; its densify threshold times 2): the strategy history (cameras and division) equal at every
    step, every loss within 1e-4 relative, the densify round's counts
    equal;
  * the memory guard with rank 1's memory share alone above the limit:
    both ranks take the maximum, stop densifying and log it, and neither
    waits for the other;
  * the entry ceiling with each rank's own reading of its step (2 ranks
    on tests/test_torch_hbm.py's scene, whose rows pass the capacity):
    both take the smaller ceiling at every reading, clamp their entry
    capacity to it, log the overflow there, and finish;
  * the port's CLI under ``python -m torch.distributed.run`` with 2 CPU
    processes: it trains, and each rank writes its log, PLY and checkpoint
    files; then the port's render tool under torchrun, with each rank's
    share of the per-rank PLY files, writes the PNGs it writes alone (bsz
    2, the last batch padded).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from grendel_tpu.engine.trainer import Trainer as JTrainer
from grendel_tpu_torch.engine.checkpoint import checkpoint_name
from grendel_tpu_torch.utils.hbm import BYTES_PER_FLAT_ENTRY, entry_ceiling
from tests.test_torch_hbm import ceiling_scene
from tests.test_torch_trainer_dist import (D, jax_config, jax_scene,
                                           run_ranks, tap_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHORT = dict(
    model=dict(sh_degree=1),
    dist=dict(bsz=2, save_strategy_history=True),
    opt=dict(iterations=8, densify_from_iter=4, densification_interval=8,
             densify_until_iter=8, densify_grad_threshold=1e-9,
             opacity_reset_interval=24),
    checkpoint_iterations=[], test_iterations=[], save_iterations=[],
    log_interval=16, quiet=True)


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return jax_scene()


@pytest.mark.parametrize("option", ["image_distribution_off",
                                    "local_sampling"])
def test_whole_image_division_matches_jax(option, scene, tmp_path,
                                          eight_devices):
    # no preload in either package: it would switch local sampling off
    dist = dict(SHORT["dist"], preload_dataset_to_gpu_threshold=0)
    if option == "local_sampling":
        dist["local_sampling"] = True
    else:
        dist["image_distribution"] = False
    config = dict(SHORT, dist=dist)
    (tmp_path / "jax").mkdir()
    jt = JTrainer(jax_config(config, str(tmp_path / "jax")), scene,
                  devices=eight_devices[:D])
    j_losses = tap_jax(jt)
    jt.train()
    assert jt._whole_image_division

    out = tmp_path / "ranks"
    out.mkdir()
    ranks = run_ranks(scene, dict(config=config), str(out))
    histories = []
    for d in (out, tmp_path / "jax"):
        with open(d / "strategy_history_ws=2.json") as f:
            histories.append(json.load(f))
    assert histories[0] == histories[1]
    tiles_y = 3
    assert all(h["division_pos"] == [0, tiles_y, 2 * tiles_y]
               for h in histories[0])
    if option == "local_sampling":       # rank g's camera has uid % 2 == g
        assert all([u % 2 for u in h["cameras"]] == [0, 1]
                   for h in histories[0])
    t_losses = ranks[0]["losses"]
    assert t_losses.shape == np.shape(j_losses) == (4, 2)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    rec = ranks[0]["records"]
    assert rec["densify_history"] == jt.densify_history


def test_memory_guard_stops_every_rank(scene, tmp_path):
    ranks = run_ranks(scene, dict(config=SHORT, memory_fraction={"1": 0.95}),
                      str(tmp_path), timeout=120.0)
    for r, rank in enumerate(ranks):
        assert rank["records"]["densify_history"] == []
        assert rank["records"]["iteration"] == 8
        with open(tmp_path / f"log_rk{r}.txt") as f:
            log = f.read()
        assert "densification stopped: HBM at 95% (limit 90%)" in log, log


def test_entry_ceiling_is_the_ranks_minimum(tmp_path):
    # rank r's step takes base_r + BYTES_PER_FLAT_ENTRY x its capacity
    # (a rank's flat lists at D = 2, the constant its loop counts), so its
    # own ceiling is fixed: (0.9 limit - base_r) / bytes per entry
    limit, per = 1 << 30, BYTES_PER_FLAT_ENTRY
    own = {0: 18_000, 1: 40_000}
    base = {r: 0.9 * limit - c * per for r, c in own.items()}
    config = dict(SHORT, dist=dict(bsz=2), pipeline=dict(
        tile_w=16, tile_h=16, isect_capacity_factor=1.0),
        opt=dict(SHORT["opt"], densify_from_iter=1000))
    ranks = run_ranks(ceiling_scene(), dict(
        config=config, hbm_gb=1,
        step_bytes={str(r): [b, per] for r, b in base.items()}),
        str(tmp_path), timeout=120.0)
    readings = [r["records"]["hbm_readings"] for r in ranks]
    assert readings[0] and [c for c, _, _ in readings[0]] == [
        c for c, _, _ in readings[1]]
    for cap, _, ceiling in readings[0]:
        assert ceiling == min(entry_ceiling(cap, int(b + per * cap), limit,
                                            per) for b in base.values())
    for r, rank in enumerate(ranks):
        rec = rank["records"]
        assert [c for _, _, c in rec["hbm_readings"]] == [
            c for _, _, c in readings[0]]
        assert rec["isect_capacity_ceiling"] == min(own.values())
        assert rec["iteration"] == 8
        caps = rank["step_caps"]
        assert caps[0] < caps[-1] == min(own.values()) >= caps.max()
        with open(tmp_path / f"log_rk{r}.txt") as f:
            log = f.read()
        assert "at the HBM ceiling; dropping farthest entries" in log, log


def test_cli_under_torchrun(tmp_path):
    out = tmp_path / "run"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "grendel_tpu_torch.scripts.train",
           "--synthetic", "--synthetic_size", "48x32", "--iterations", "8",
           "--bsz", "2", "--densify_from_iter", "2",
           "--densification_interval", "4", "--densify_until_iter", "8",
           "--redistribute_gaussians_frequency", "1",
           "--checkpoint_iterations", "8", "--n_devices", "2",
           "--device", "cpu", "-q", "-m", str(out)]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-3000:]
    for r in range(2):
        with open(out / f"python_ws=2_rk={r}.log") as f:
            log = f.read()
        assert "training done: 8 iters" in log, log
        assert "densify #2" in log and "redistributed" in log, log
        assert (out / "point_cloud" / "iteration_8"
                / f"point_cloud_rk{r}_ws2.ply").exists()
        assert (out / "checkpoints" / "8" / checkpoint_name(2, r)).exists()
    assert (out / "checkpoints" / "8" / "tuner.json").exists()

    from PIL import Image

    from grendel_tpu_torch.scripts import render

    alone = tmp_path / "alone"
    shutil.copytree(out, alone)
    render.main(["-m", str(alone), "--device", "cpu", "--bsz", "2"])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "grendel_tpu_torch.scripts.render",
           "-m", str(out), "--bsz", "2", "--device", "cpu"]
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    for split, n in (("train", 12), ("test", 2)):
        d = os.path.join("ours_8", "renders")
        names = sorted(os.listdir(alone / split / d))
        assert names == sorted(os.listdir(out / split / d)) and len(names) == n
        for fn in names:
            a, b = (np.asarray(Image.open(m / split / d / fn))
                    for m in (alone, out))
            np.testing.assert_array_equal(a, b)
            assert a.mean() > 1
