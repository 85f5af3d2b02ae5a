"""Port parity of the data layer and the in-repo training scenes:
grendel_tpu_torch's COLMAP and Blender readers, Scene, SceneDataset,
StructuredSyntheticScene and lookat_camera against grendel_tpu's on the
same inputs; the port's training CLI, the options of its Trainer and its
timers on the CPU.

Everything here is numpy on both sides, so the comparisons are exact:
camera matrices, point clouds, decoded ground truth, raytraced images and
the sampled camera sequence must be equal.
"""

import json
import os

import numpy as np
import pytest
import torch

from grendel_tpu import testing as JT
from grendel_tpu.data import colmap as JC
from grendel_tpu.data import readers as JR
from grendel_tpu.data import scene as JS
from grendel_tpu_torch import testing as TT
from grendel_tpu_torch.data import colmap as TC
from grendel_tpu_torch.data import readers as TR
from grendel_tpu_torch.data import scene as TS
from grendel_tpu_torch.engine.checkpoint import find_latest_checkpoint
from grendel_tpu_torch.scripts import train as train_cli


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores; torch's spinning intra-op
    threads would then slow every test on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_png(path, h, w, color):
    from PIL import Image

    Image.fromarray(np.full((h, w, 3), color, np.uint8)).save(path)


@pytest.fixture
def colmap_dir(tmp_path):
    """tests/test_data.py's minimal COLMAP scene, written by the port's
    writers (10 images, 50 points)."""
    sparse = tmp_path / "sparse" / "0"
    sparse.mkdir(parents=True)
    (tmp_path / "images").mkdir()
    w, h = 64, 48
    cams = {1: TC.ColmapCamera(1, "PINHOLE", w, h,
                               np.array([60.0, 58.0, w / 2, h / 2]))}
    imgs = {}
    rng = np.random.default_rng(0)
    for i in range(10):
        q = rng.normal(size=4)
        imgs[i + 1] = TC.ColmapImage(i + 1, q / np.linalg.norm(q),
                                     rng.normal(size=3) + [0, 0, 4], 1,
                                     f"im_{i:03d}.png")
        _write_png(str(tmp_path / "images" / f"im_{i:03d}.png"), h, w,
                   40 + 20 * (i % 3))
    TC.write_cameras_binary(str(sparse / "cameras.bin"), cams)
    TC.write_images_binary(str(sparse / "images.bin"), imgs)
    rgb = (rng.uniform(size=(50, 3)) * 255).astype(np.uint8)
    TC.write_points3d_binary(str(sparse / "points3D.bin"),
                             rng.normal(size=(50, 3)), rgb)
    return tmp_path


def _same_infos(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.uid, g.image_name, g.width, g.height) == \
            (w.uid, w.image_name, w.width, w.height)
        for f in ("R", "T"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert (g.fovx, g.fovy) == (w.fovx, w.fovy)


def test_colmap_scene_matches_jax(colmap_dir):
    # the port's binary writers give files the JAX package reads the same
    x_t = TC.read_points3d_binary(str(colmap_dir / "sparse/0/points3D.bin"))
    x_j = JC.read_points3d_binary(str(colmap_dir / "sparse/0/points3D.bin"))
    for a, b in zip(x_t, x_j):
        np.testing.assert_array_equal(a, b)
    for split in (False, True):
        t = TR.read_colmap_scene(str(colmap_dir), eval_split=split,
                                 llffhold=8)
        j = JR.read_colmap_scene(str(colmap_dir), eval_split=split,
                                 llffhold=8)
        _same_infos(t.train_cameras, j.train_cameras)
        _same_infos(t.test_cameras, j.test_cameras)
        np.testing.assert_array_equal(t.point_cloud.points,
                                      j.point_cloud.points)
        np.testing.assert_array_equal(t.point_cloud.colors,
                                      j.point_cloud.colors)
        assert t.nerf_normalization["radius"] == \
            j.nerf_normalization["radius"]
    assert len(t.test_cameras) == 2


@pytest.mark.parametrize("resolution", [-1, 2])
def test_scene_and_dataset_match_jax(colmap_dir, resolution):
    t = TS.Scene(str(colmap_dir), eval_split=True, llffhold=8, seed=3,
                 resolution=resolution)
    j = JS.Scene(str(colmap_dir), eval_split=True, llffhold=8, seed=3,
                 resolution=resolution)
    assert t.cameras_extent == j.cameras_extent
    for tc, jc in zip(t.train_cameras + t.test_cameras,
                      j.train_cameras + j.test_cameras):
        assert (tc.uid, tc.image_name, tc.width, tc.height) == \
            (jc.uid, jc.image_name, jc.width, jc.height)
        np.testing.assert_array_equal(tc.gt_image_u8, jc.gt_image_u8)
        for f in ("world_view", "full_proj", "camera_center"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    # the same seed draws the same camera sequence, epoch after epoch
    for seed in (0, 7):
        dt = TS.SceneDataset(t.train_cameras, seed=seed)
        dj = JS.SceneDataset(j.train_cameras, seed=seed)
        for _ in range(30):
            assert [c.uid for c in dt.next_batch(3)] == \
                [c.uid for c in dj.next_batch(3)]
        assert dt.epoch == dj.epoch == 12 and dt.epoch_len == 8
    with pytest.raises(ValueError, match="at least one camera"):
        TS.SceneDataset([])


def test_blender_decode_matches_jax(tmp_path):
    from PIL import Image

    frames = []
    (tmp_path / "train").mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        c2w = np.eye(4)
        c2w[:3, 3] = rng.normal(size=3) + [0, 0, 3]
        frames.append({"file_path": f"train/r_{i}",
                       "transform_matrix": c2w.tolist()})
        arr = rng.integers(0, 256, (16, 24, 4)).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / "train" / f"r_{i}.png")
    with open(tmp_path / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    for white in (False, True):
        t = TR.read_blender_scene(str(tmp_path), white, eval_split=False)
        j = JR.read_blender_scene(str(tmp_path), white, eval_split=False)
        _same_infos(t.train_cameras, j.train_cameras)
        for ti, ji in zip(t.train_cameras, j.train_cameras):
            np.testing.assert_array_equal(TS.decode_image(ti),
                                          JS.decode_image(ji))


def test_structured_scene_matches_jax():
    kw = dict(width=48, height=32, n_cams=10, llffhold=5, n_init_points=400,
              seed=1)
    t, j = TT.StructuredSyntheticScene(**kw), JT.StructuredSyntheticScene(**kw)
    assert len(t.train_cameras) == 8 and len(t.test_cameras) == 2
    assert t.cameras_extent == j.cameras_extent
    for tc, jc in zip(t.train_cameras + t.test_cameras,
                      j.train_cameras + j.test_cameras):
        assert (tc.uid, tc.image_name) == (jc.uid, jc.image_name)
        np.testing.assert_array_equal(tc.gt_image_u8, jc.gt_image_u8)
        for f in ("world_view", "full_proj", "camera_center"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    np.testing.assert_array_equal(t.point_cloud.points, j.point_cloud.points)
    np.testing.assert_array_equal(t.point_cloud.colors, j.point_cloud.colors)
    # the raytracer alone, with a background, and the look-at camera
    cam = TT.lookat_camera([0.0, -2.0, -3.0], [0.0, 0.5, 0.0], 40, 24)
    jcam = JT.lookat_camera([0.0, -2.0, -3.0], [0.0, 0.5, 0.0], 40, 24)
    np.testing.assert_array_equal(TT.raytrace_image(cam, bg=(0.2, 0.3, 0.4)),
                                  JT.raytrace_image(jcam, bg=(0.2, 0.3, 0.4)))
    with pytest.raises(ValueError, match="degenerate"):
        TT.lookat_camera([0.0, -2.0, 0.0], [0.0, 0.5, 0.0], 40, 24)


def test_synthetic_scene_renders_its_ground_truth():
    s = TT.SyntheticScene(n_cams=3, n_test=1, width=48, height=32,
                          n_gaussians=60, n_init_points=50, seed=2,
                          device="cpu")
    assert len(s.train_cameras) == 3 and len(s.test_cameras) == 1
    assert s.point_cloud.points.shape == (50, 3)
    gts = np.stack([c.gt_image_u8 for c in s.train_cameras + s.test_cameras])
    assert gts.shape == (4, 3, 32, 48) and gts.dtype == np.uint8
    # every view sees some Gaussians on the black background, and the
    # views differ
    assert all(g.max() > 0 for g in gts)
    assert not np.array_equal(gts[0], gts[1])


def test_train_cli_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "run")
    flags = ["--synthetic", "--synthetic_size", "48x32",
             "--synthetic_gaussians", "60", "--synthetic_points", "80",
             "--sh_degree", "1", "--bsz", "2", "--iterations", "8",
             "--densify_from_iter", "2", "--densification_interval", "4",
             "--densify_until_iter", "8", "--densify_grad_threshold", "1e-9",
             "--test_iterations", "8", "--save_iterations", "8",
             "--checkpoint_iterations", "4", "--log_interval", "4",
             "--device", "cpu", "-m", out]
    assert train_cli.main(flags) == 0
    log = capsys.readouterr().out
    assert "densify #1" in log and "eval test" in log
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_8",
                                       "point_cloud.ply"))
    with open(os.path.join(out, "args.json")) as f:
        assert json.load(f)["iterations"] == 8
    ckpt = find_latest_checkpoint(out)
    assert ckpt is not None and ckpt.endswith("4")
    # --auto_start_checkpoint resumes from it
    assert train_cli.main(flags[:-4] + ["--iterations", "12",
                                        "--auto_start_checkpoint",
                                        "--checkpoint_iterations", "12",
                                        "--device", "cpu", "-m", out]) == 0
    assert find_latest_checkpoint(out).endswith("12")
    assert "tuner state restored" in capsys.readouterr().out


@pytest.fixture(scope="module")
def small_scene():
    return TT.SyntheticScene(n_cams=4, n_test=1, width=48, height=32,
                             n_gaussians=60, n_init_points=80, seed=4,
                             device="cpu")


def _small_config(**over):
    from grendel_tpu_torch.config import TrainConfig

    cfg = TrainConfig()
    cfg.model.sh_degree = 1
    cfg.dist.bsz = 2
    cfg.opt.iterations = 4
    cfg.test_iterations, cfg.save_iterations = [], []
    cfg.log_interval = 2
    cfg.quiet = True
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg.finalize()


@pytest.mark.parametrize("option", ["plain", "stop_update_param",
                                    "drop_initial_3dgs_p", "enable_timer",
                                    "check_cpu_memory", "random_background"])
def test_trainer_options(small_scene, option):
    """Each option of the loop's constructor and logging, on a 4-iteration
    run: frozen parameters, a thinned initial cloud, the stage timer and
    memory log lines, and a random background."""
    import io

    from grendel_tpu_torch.engine.trainer import Trainer

    over = {"stop_update_param": dict(stop_update_param=True),
            "drop_initial_3dgs_p": dict(drop_initial_3dgs_p=0.5),
            "enable_timer": dict(enable_timer=True),
            "check_cpu_memory": dict(check_cpu_memory=True)}.get(option, {})
    cfg = _small_config(**over)
    if option == "random_background":
        cfg.opt.random_background = True
    log = io.StringIO()
    tr = Trainer(cfg, small_scene, device="cpu", log_file=log)
    p0 = [p.clone() for p in tr.state.params]
    n0 = int(tr.state.alive.sum())
    tr.train()
    text = log.getvalue()
    assert int(tr.state.iteration) == 4 and "iter 4:" in text
    assert all(bool(torch.isfinite(p).all()) for p in tr.state.params)
    moved = any(not torch.equal(a, b) for a, b in zip(p0, tr.state.params))
    assert moved == (option != "stop_update_param")
    assert (n0 < 80) == (option == "drop_initial_3dgs_p")
    assert ("timers: " in text) == (option == "enable_timer")
    assert ("cpu_maxrss=" in text) == (option == "check_cpu_memory")


def test_trainer_end2end_time_pauses_for_eval_and_saves(small_scene,
                                                        monkeypatch):
    """The loop's end-to-end time leaves out eval and checkpoint saves."""
    import io
    import time as _time

    from grendel_tpu_torch.engine.trainer import Trainer

    cfg = _small_config(test_iterations=[2], checkpoint_iterations=[4])
    tr = Trainer(cfg, small_scene, device="cpu", log_file=io.StringIO())
    slow = 0.3
    monkeypatch.setattr(tr, "_run_eval", lambda *a: _time.sleep(slow))
    monkeypatch.setattr(tr, "save_checkpoint", lambda *a: _time.sleep(slow))
    t0 = _time.perf_counter()
    tr.train()
    wall = _time.perf_counter() - t0
    assert 0 < tr.end2end.total_seconds() <= wall - 2 * slow
    assert "end2end (excl. eval/save)" in tr.log.getvalue()


def test_timers():
    import time as _time

    from grendel_tpu_torch.utils.timer import End2endTimer, Timer

    t = Timer(device="cpu")
    for _ in range(3):
        t.start("50 step")
        _time.sleep(0.002)
        t.stop("50 step")
    t.stop("never started")
    assert t.elapsed_ms("50 step") >= 6.0
    report = t.report()
    assert report.startswith("50 step: ") and "(x3, avg" in report
    assert t.report() == ""                      # reset after a report
    off = Timer(enabled=False, device="cpu")
    off.start("a")
    off.stop("a")
    assert off.report() == ""
    e = End2endTimer()
    e.start()
    _time.sleep(0.002)
    e.pause()
    paused = e.total_seconds()
    _time.sleep(0.002)
    assert e.total_seconds() == paused >= 0.002


def test_train_cli_flags():
    p = train_cli.build_parser()
    a = p.parse_args(["-s", "scene", "--bsz", "4", "--tile", "16x16",
                      "--lr_scale_mode", "linear", "--white_background"])
    cfg = train_cli.args_to_config(a)
    assert cfg.dist.bsz == 4 and cfg.opt.lr_scale_mode == "linear"
    assert (cfg.pipeline.tile_w, cfg.pipeline.tile_h) == (16, 16)
    assert cfg.model.white_background and cfg.model.source_path == "scene"
    # finalize ran: the opacity reset stops with the densification
    assert cfg.opt.opacity_reset_until_iter == 15_000 + 4
    d = p.parse_args([])
    assert (d.iterations, d.bsz, d.device) == (30_000, 1, "cuda")
    for extra in (["--n_devices", "2"], ["--local_sampling"],
                  ["--save_strategy_history"],
                  ["--grad_normalization_mode", "divide_by_visible_count"]):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            train_cli.main(["--synthetic", "--device", "cpu"] + extra)
    with pytest.raises(SystemExit):
        train_cli.main(["--device", "cpu"])
