"""Port parity of the tools: grendel_tpu_torch/scripts/{render,
ckpt_to_ply, analyze, export_structured_dataset, profile_step}.py against
the JAX package's scripts of the same names, on the CPU.

  * render: random Gaussians (testing.random_gaussians) saved as a PLY
    beside an ``args.json`` of a small ``--synthetic`` run; both render
    tools rebuild the scene from it and render every view (JAX's on its
    8-device CPU mesh, the port's with ``render_batch``). At most 0.5% of
    the pixels may differ, by one level at most (the two blends stop
    differently on saturated pixels, ROADMAP queue 3). Both at bsz 1, JAX's
    default: JAX's tool sizes its exchange buckets for one camera and
    drops Gaussians of a batch's later cameras. The port's run at bsz 2,
    whose last batch is padded, writes the same PNGs as at bsz 1.
  * ckpt_to_ply: a port checkpoint of 2 ranks gives PLY fields bit-equal
    to those JAX's script writes from it.
  * analyze: both miners give equal dicts on the logs of a port CLI run.
  * export_structured_dataset: byte-equal COLMAP ``.bin`` files and PNGs
    of equal pixels.
  * profile_step: its stage keys are the JAX tool's, every time finite.
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from grendel_tpu_torch import testing
from grendel_tpu_torch.convert import params_from_numpy
from grendel_tpu_torch.engine.gaussian_io import save_ply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH_ARGS = dict(synthetic=True, synthetic_size="64x48", seed=0,
                  sh_degree=3, synthetic_gaussians=100, synthetic_points=50,
                  llffhold=8, white_background=False, source_path="")


def _model_dir(path, iteration=7):
    """A model directory: random Gaussians as a PLY and a synthetic run's
    args.json."""
    fields, alive = testing.params_fields(
        *testing.random_gaussians(2, 400, sh_degree=3), 512)
    params, alive = params_from_numpy(fields, alive, "cpu")
    save_ply(os.path.join(path, "point_cloud", f"iteration_{iteration}",
                          "point_cloud.ply"), params, alive)
    with open(os.path.join(path, "args.json"), "w") as f:
        json.dump(SYNTH_ARGS, f)
    return path


def _pngs(model_path, split, it=7, kind="renders"):
    d = os.path.join(model_path, split, f"ours_{it}", kind)
    return {fn: np.asarray(Image.open(os.path.join(d, fn)))
            for fn in sorted(os.listdir(d))}


def test_render_cli_matches_jax(tmp_path, monkeypatch):
    from grendel_tpu_torch.scripts import render as t_render
    from scripts import render as j_render

    runs = {k: _model_dir(str(tmp_path / k)) for k in ("jax", "port",
                                                       "port_bsz2")}
    monkeypatch.setattr(sys, "argv", ["render.py", "-m", runs["jax"],
                                      "--platform", "cpu"])
    j_render.main()
    t_render.main(["-m", runs["port"], "--device", "cpu"])
    t_render.main(["-m", runs["port_bsz2"], "--device", "cpu", "--bsz", "2"])
    for split, n_views in (("train", 12), ("test", 2)):
        got, want = _pngs(runs["port"], split), _pngs(runs["jax"], split)
        assert sorted(got) == sorted(want) and len(got) == n_views
        for fn in want:
            diff = np.abs(got[fn].astype(int) - want[fn].astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.005, fn
            assert got[fn].mean() > 5          # not an empty render
        padded = _pngs(runs["port_bsz2"], split)
        assert all(np.array_equal(padded[fn], got[fn]) for fn in got)
    # the ground truth of the port's scene, bit for bit
    scene = testing.SyntheticScene(width=64, height=48, sh_degree=1, seed=0,
                                   n_gaussians=100, n_init_points=50,
                                   device="cpu")
    gts = _pngs(runs["port"], "test", kind="gt")
    assert np.array_equal(gts["00001.png"],
                          scene.test_cameras[1].gt_image_u8.transpose(1, 2, 0))


def _checkpoint(path):
    """A 2-rank port checkpoint set at iteration 24."""
    from grendel_tpu_torch.engine.checkpoint import save_checkpoint
    from grendel_tpu_torch.engine.train import train_state_init

    for r in range(2):
        fields, alive = testing.params_fields(
            *testing.random_gaussians(10 + r, 150 + 40 * r, sh_degree=1),
            256)
        state = train_state_init(*params_from_numpy(fields, alive, "cpu"),
                                 start_iteration=24)
        save_checkpoint(os.path.join(path, "checkpoints", "24"), state,
                        rank=r, world_size=2)
    return path


def test_ckpt_to_ply_matches_jax(tmp_path, monkeypatch):
    from grendel_tpu_torch.scripts import ckpt_to_ply as t_tool
    from grendel_tpu_torch.utils.ply import read_ply
    from scripts import ckpt_to_ply as j_tool

    j_dir, t_dir = (_checkpoint(str(tmp_path / k)) for k in ("jax", "port"))
    monkeypatch.setattr(sys, "argv", ["ckpt_to_ply.py", "-m", j_dir])
    j_tool.main()
    path = t_tool.main(["-m", t_dir, "--iteration", "24"])
    rel = os.path.join("point_cloud", "iteration_24", "point_cloud.ply")
    assert path == os.path.join(t_dir, rel)
    got, want = read_ply(path), read_ply(os.path.join(j_dir, rel))
    assert list(got) == list(want) and got["x"].shape == (150 + 190,)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A short run of the port's training CLI on the CPU with evals, the
    stage timers and a densify round."""
    from grendel_tpu_torch.scripts import train

    out = str(tmp_path_factory.mktemp("port_run"))
    train.main(["--synthetic", "--synthetic_size", "48x32", "--iterations",
                "12", "--bsz", "2", "--densify_from_iter", "2",
                "--densification_interval", "4", "--densify_until_iter", "8",
                "--test_iterations", "6", "12", "--log_interval", "4",
                "--enable_timer", "--device", "cpu", "-q", "-m", out])
    return out


def test_analyze_matches_jax(port_run, tmp_path):
    from grendel_tpu_torch.scripts import analyze as t_an
    from scripts import analyze as j_an

    with open(os.path.join(port_run, "results_test.json"), "w") as f:
        json.dump({"ours_12": {"SSIM": 0.5, "PSNR": 20.0, "LPIPS": None}}, f)
    got, want = t_an.analyze_run(port_run), j_an.analyze_run(port_run)
    assert got == want
    assert (len(got["evals"]) == 4 and got["densify"] and got["stages"]
            and got["end2end_min"] is not None and got["final_n3dgs"])
    t_an.main(["-m", port_run, "--stages", "--json",
               str(tmp_path / "a.json")])
    with open(tmp_path / "a.json") as f:
        assert json.load(f) == json.loads(json.dumps([want]))


def test_export_structured_dataset_matches_jax(tmp_path):
    from grendel_tpu_torch.scripts import export_structured_dataset as t_ex
    from scripts import export_structured_dataset as j_ex

    kw = dict(width=40, height=24, n_cams=5, n_points=300, seed=1,
              llffhold=4)
    j_ex.export_structured_dataset(str(tmp_path / "jax"), **kw)
    t_ex.main(["--out", str(tmp_path / "port"), "--size", "40x24",
               "--cams", "5", "--points", "300", "--seed", "1",
               "--llffhold", "4"])
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        a, b = (open(tmp_path / k / "sparse" / "0" / name, "rb").read()
                for k in ("port", "jax"))
        assert a == b, name
    names = sorted(os.listdir(tmp_path / "jax" / "images"))
    assert names == sorted(os.listdir(tmp_path / "port" / "images"))
    assert len(names) == 6           # the views the rig makes of 5
    for fn in names:
        a, b = (np.asarray(Image.open(tmp_path / k / "images" / fn))
                for k in ("port", "jax"))
        np.testing.assert_array_equal(a, b)


def test_profile_step_keys_match_jax(capsys, tmp_path):
    from grendel_tpu_torch.scripts import profile_step

    with open(os.path.join(ROOT, "scripts", "profile_step.py")) as f:
        jax_keys = set(re.findall(r'times\["(\w+)"\] =', f.read()))
    out = profile_step.main(["--height", "32", "--width", "48", "--n", "200",
                             "--bsz", "2", "--steps", "1", "--trace",
                             str(tmp_path), "--device", "cpu"])
    assert set(out["times"]) == jax_keys and len(jax_keys) == 8
    with open(tmp_path / "trace_rk0.json") as f:
        assert json.load(f)["traceEvents"]
    assert all(np.isfinite(v) and v > 0 for v in out["times"].values())
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert set(json.loads(last)["profile"]) == jax_keys


@pytest.mark.parametrize("tool", ["render", "metrics", "profile_step"])
def test_tools_default_to_the_card(tool, tmp_path, monkeypatch):
    """Without ``--device cpu`` a tool asks for the card, and raises
    where there is none."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"grendel_tpu_torch.scripts.{tool}").main
    argv = {"render": ["-m", _model_dir(str(tmp_path))],
            "metrics": ["-m", str(tmp_path)], "profile_step": []}[tool]
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        main(argv)
