"""The reference against the port's plain versions on the CPU, at tiny
sizes: projection, tile lists, frame, loss, and the whole step."""

import shutil

import pytest
import torch

from gsbench import harness, scene
from gsbench.entries import common
from gsbench.reference import render as R
from gsbench.reference.step import (Optim, RenderSpec, loss_and_grads,
                                    run_steps)

H, W, TW, TH, MPT = 40, 72, 32, 16, 2048


@pytest.fixture
def setup():
    gen = common.generator(11, torch.device("cpu"))
    params, alive = scene.garden_gaussians(500, 768, 1.2, (-3.5, -2.0),
                                           (0.3, 0.95), 3, gen)
    host = scene.orbit_camera(W, H, 5.0, 0.3)
    return params, alive, host, scene.device_camera(host, "cpu")


def program(params, alive, host):
    from grendel_tpu_torch.engine.render import RenderConfig, render_batch
    from grendel_tpu_torch.models.gaussian_model import GaussianParams

    cfg = RenderConfig(img_h=H, img_w=W, tile_w=TW, tile_h=TH,
                       isect_capacity=1 << 14, max_per_tile=MPT)
    with torch.no_grad():
        return render_batch(GaussianParams(**params), alive,
                            common.program_camera(host, "cpu"), 3, cfg,
                            bg=torch.zeros(3))


def test_projection_and_lists_and_frame(setup):
    params, alive, host, cam = setup
    img, splats, aux = program(params, alive, host)
    s = R.project(params, alive, cam, H, W, 3)
    vis = s.radius > 0
    assert torch.equal(vis, splats.radii[0] > 0)
    assert torch.equal(s.radius, splats.radii[0].long())
    torch.testing.assert_close(s.means2d[vis], splats.means2d[0][vis])
    torch.testing.assert_close(s.conic[vis], splats.conics[0][vis],
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s.color[vis], splats.colors[0][vis])
    lists = R.tile_lists(s, H, W, TW, TH)
    assert torch.equal(lists.counts, aux.n_entries[0].long())
    frame, walk = R.render(s, lists, H, W, TW, TH, MPT, torch.zeros(3))
    assert (frame - img[0]).abs().max() < 1e-5
    assert 0 < walk.blended <= walk.walked


def test_loss_matches_the_programs(setup):
    from grendel_tpu_torch.engine.loss import batch_loss

    params, alive, host, cam = setup
    img, _, _ = program(params, alive, host)
    gt = torch.rand(1, 3, H, W, generator=torch.Generator().manual_seed(1))
    ref = R.camera_loss(img[0], gt[0], 0.2)
    got, _ = batch_loss(img, gt, 0.2)
    assert float(ref) == pytest.approx(float(got), rel=1e-5)


def test_gradients_match_the_programs(setup):
    from grendel_tpu_torch.engine.train import train_state_init, train_step
    from grendel_tpu_torch.engine.train import XyzLrSchedule
    from grendel_tpu_torch.engine.render import RenderConfig
    from grendel_tpu_torch.models.gaussian_model import GaussianParams
    from grendel_tpu_torch.models.optimizer import scaled_lrs

    params, alive, host, cam = setup
    gt = torch.randint(0, 255, (1, 3, H, W), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(2))
    lrs, s = scaled_lrs(0.0025, 0.05, 0.005, 0.001, bsz=1)
    st = train_state_init(GaussianParams(**{k: v.clone() for k, v in
                                            params.items()}), alive)
    cfg = RenderConfig(img_h=H, img_w=W, tile_w=TW, tile_h=TH,
                       isect_capacity=1 << 14, max_per_tile=MPT)
    st1, m = train_step(st, common.program_camera(host, "cpu"), gt,
                        torch.zeros(3), cfg, 3, 1, 0.2, lrs,
                        XyzLrSchedule(1.6e-4, 1.6e-6, 0.01, 30000))
    spec = RenderSpec(H, W, TW, TH, MPT)
    loss, grads, _, _ = loss_and_grads(params, alive, [cam], [gt[0]],
                                       torch.zeros(3), spec, 3, 0.2)
    assert loss == pytest.approx(float(m["loss"]), rel=1e-5)
    for k, g in grads.items():
        got = getattr(st1.adam.mu, k) / (1 - lrs.beta1)
        scale = float(g.abs().max()) + 1e-30
        assert float((got - g).abs().max()) / scale < 1e-3, k
    opt = Optim(1.6e-4, 1.6e-6, 30000, 1.0, 0.0025, 0.05, 0.005, 0.001, 0.2)
    ref = run_steps(params, alive, [([cam], [gt[0]])], torch.zeros(3), spec,
                    opt, 0, lambda it: 3)
    for k, p in ref.params.items():
        torch.testing.assert_close(p, getattr(st1.params, k), rtol=1e-4,
                                   atol=1e-6)


def test_truck_cameras_are_the_readers(tmp_path):
    from grendel_tpu_torch.cameras import batch_camera_arrays
    from grendel_tpu_torch.data.readers import read_colmap_scene

    w, h = harness.load_config("tnt_truck_1k")["image_size"]
    rig = scene.structured_rig(10, w, h, 1.1)
    pts, cols = scene.structured_points(500, 3)
    scene.write_colmap(str(tmp_path), rig, pts, cols)
    (tmp_path / "images").mkdir()
    for c in rig:
        shutil.copy(harness.HERE / "data" / "truck" / f"{c.name}.jpg",
                    tmp_path / "images")
    info = read_colmap_scene(str(tmp_path))
    got = sorted(info.train_cameras, key=lambda i: i.image_name)
    assert [i.image_name for i in got] == [c.name for c in rig]
    from grendel_tpu_torch.data.scene import camera_from_info
    for ci, c in zip(got, rig):
        cam = camera_from_info(0, ci, decode=False, size=(w, h),
                               device="cpu")
        mine = scene.device_camera(c, "cpu")
        theirs = batch_camera_arrays([cam], "cpu")
        for a, b in zip(mine, theirs):
            torch.testing.assert_close(a, b[0], rtol=1e-5, atol=1e-6)
    assert info.point_cloud.points.shape == pts.shape
