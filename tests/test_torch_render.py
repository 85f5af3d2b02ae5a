"""Port parity of the render path as a whole, model interchange, and the
port's package rules.

Renders: grendel_tpu_torch's render_batch (bsz 2, the camera-blocked
single-launch path) and render_image against grendel_tpu's with
backend="pallas_interpret", on the flagship scene of __graft_entry__.py
(capacity 512, 300 live, 128x160, SH 3) from a numpy seed, with a fixed
non-zero background. No pixel saturates there, so the tolerance is
atol=rtol=1e-5 (see test_torch_rasterize.py).
"""

import ast
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from grendel_tpu.cameras import batch_camera_arrays as j_batch_cams
from grendel_tpu.cameras import camera_arrays as j_cam
from grendel_tpu.engine import gaussian_io as j_io
from grendel_tpu.engine import render as JR
from grendel_tpu.models.gaussian_model import GaussianParams as JParams
from grendel_tpu_torch import cameras, convert, testing
from grendel_tpu_torch.engine import gaussian_io, render as TR
from grendel_tpu_torch.models import gaussian_model

H, W, SH = 128, 160, 3
BG = np.array([0.2, 0.1, 0.3], np.float32)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores; torch's spinning intra-op
    threads would then slow every test on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flagship(seed=0):
    g = testing.random_gaussians(seed, 300, sh_degree=SH)
    return testing.params_fields(*g, 512)


def _cfgs(tile_w=16, tile_h=16):
    kw = dict(img_h=H, img_w=W, tile_w=tile_w, tile_h=tile_h,
              isect_capacity=8192, max_per_tile=512)
    return (TR.RenderConfig(**kw),
            JR.RenderConfig(**kw, backend="pallas_interpret"))


def _jax_params(fields, alive):
    return (JParams(**{k: jnp.asarray(v) for k, v in fields.items()}),
            jnp.asarray(alive))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)


def test_render_batch_matches_jax():
    """At the main path's 32x16 tiles; render_image below covers 16x16."""
    fields, alive = _flagship()
    cams = [testing.make_test_camera(W, H, angle=0.3 * i) for i in range(2)]
    cfg_t, cfg_j = _cfgs(32, 16)
    jp, ja = _jax_params(fields, alive)
    fn = jax.jit(lambda p, a, c: JR.render_batch(p, a, c, SH, cfg_j,
                                                 bg=jnp.asarray(BG)))
    img_j, _, aux_j = fn(jp, ja, j_batch_cams(cams))
    tp, ta = convert.params_from_numpy(fields, alive, "cpu")
    tc = cameras.batch_camera_arrays(cams, "cpu")
    img_t, splats, aux_t = TR.render_batch(tp, ta, tc, SH, cfg_t,
                                           bg=torch.tensor(BG))
    assert img_t.shape == (2, 3, H, W) and splats.means2d.shape == (2, 512, 2)
    assert aux_t.final_t.min() > 1e-2             # unsaturated
    _close(img_t, img_j)
    _close(aux_t.final_t, aux_j.final_t)
    np.testing.assert_array_equal(aux_t.n_entries.numpy(),
                                  np.asarray(aux_j.n_entries))
    np.testing.assert_array_equal(aux_t.num_isects.numpy(),
                                  np.asarray(aux_j.num_isects))
    # the plain per-camera reference renders the same images
    img_p, _, _ = TR.render_batch(tp, ta, tc, SH,
                                  cfg_t._replace(backend="torch"),
                                  bg=torch.tensor(BG))
    _close(img_p, img_j)


def test_render_image_matches_jax():
    fields, alive = _flagship(seed=1)
    cam = testing.make_test_camera(W, H, angle=0.2)
    cfg_t, cfg_j = _cfgs()
    jp, ja = _jax_params(fields, alive)
    fn = jax.jit(lambda p, a, c: JR.render_image(p, a, c, SH, cfg_j,
                                                 bg=jnp.asarray(BG)))
    img_j, aux_j = fn(jp, ja, j_cam(cam))
    tp, ta = convert.params_from_numpy(fields, alive, "cpu")
    img_t, aux_t = TR.render_image(tp, ta, cameras.camera_arrays(cam, "cpu"),
                                   SH, cfg_t, bg=torch.tensor(BG))
    _close(img_t, img_j)
    _close(aux_t.final_t, aux_j.final_t)
    assert int(aux_t.num_isects) == int(aux_j.num_isects)
    # with a post-cull blend budget the image is unchanged
    img_c, _ = TR.render_image(
        tp, ta, cameras.camera_arrays(cam, "cpu"), SH,
        cfg_t._replace(blend_capacity=int(aux_t.num_isects) + 8),
        bg=torch.tensor(BG))
    np.testing.assert_array_equal(img_c.numpy(), img_t.numpy())


def test_ply_round_trip_both_directions(tmp_path):
    fields, alive = _flagship(seed=2)
    # JAX save -> port load
    jp, ja = _jax_params(fields, alive)
    j_io.save_ply(str(tmp_path / "jax.ply"), jp, np.asarray(ja))
    tp, ta = gaussian_io.load_ply(str(tmp_path / "jax.ply"), device="cpu")
    for name in gaussian_model.GaussianParams._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), fields[name],
                                      err_msg=name)
    np.testing.assert_array_equal(ta.numpy(), alive)
    # port save -> JAX load
    gaussian_io.save_ply(str(tmp_path / "port.ply"), tp, ta)
    jp2, ja2 = j_io.load_ply(str(tmp_path / "port.ply"))
    for name in gaussian_model.GaussianParams._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jp2, name)),
                                      fields[name], err_msg=name)
    np.testing.assert_array_equal(np.asarray(ja2), alive)
    # the two files hold the same fields
    jf = j_io.params_to_ply_fields(jp, np.asarray(ja))
    tf = gaussian_io.params_to_ply_fields(tp, ta)
    assert list(jf) == list(tf)
    for k in jf:
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)


def test_params_from_numpy_and_ply_render_alike(tmp_path):
    fields, alive = _flagship(seed=3)
    tp, ta = convert.params_from_numpy(fields, alive, "cpu")
    gaussian_io.save_ply(str(tmp_path / "m.ply"), tp, ta)
    lp, la = gaussian_io.load_ply(str(tmp_path / "m.ply"), device="cpu")
    cams = cameras.batch_camera_arrays(
        [testing.make_test_camera(W, H, angle=0.5 * i) for i in range(2)], "cpu")
    cfg, _ = _cfgs(32, 16)
    a, _, _ = TR.render_batch(tp, ta, cams, SH, cfg, bg=torch.tensor(BG))
    b, _, _ = TR.render_batch(lp, la, cams, SH, cfg, bg=torch.tensor(BG))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert 0.05 < float(a.mean()) < 1.0
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_numpy({"means3d": fields["means3d"]}, alive, "cpu")


def test_garden_scene_shape():
    s = testing.garden_scene(seed=0, device="cpu")
    assert (s.img_h, s.img_w, s.sh_degree) == (840, 1296, 3)
    assert s.alive.shape == (262_144,) and int(s.alive.sum()) == 200_000
    assert s.params.sh_rest.shape == (262_144, 15, 3)
    assert [c.width for c in s.cameras] == [1296, 1296]
    np.testing.assert_allclose(s.cameras[1].camera_center,
                               [-5.0 * np.sin(0.1), 0.0, -5.0 * np.cos(0.1)],
                               atol=1e-5)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "grendel_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "grendel_tpu"), (path, mod)


def test_entry_points_default_to_the_card_and_never_fall_back(monkeypatch,
                                                              tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fields, alive = _flagship()
    tp, ta = convert.params_from_numpy(fields, alive, "cpu")
    gaussian_io.save_ply(str(tmp_path / "m.ply"), tp, ta)
    cam = testing.make_test_camera(W, H)
    calls = [
        lambda: gaussian_model.empty_params(16),
        lambda: convert.params_from_numpy(fields, alive),
        lambda: cameras.batch_camera_arrays([cam]),
        lambda: cameras.camera_arrays(cam),
        lambda: gaussian_io.load_ply(str(tmp_path / "m.ply")),
        lambda: testing.garden_scene(0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    cfg = TR.RenderConfig(img_h=H, img_w=W, backend="torch")
    with pytest.raises(ValueError, match="plain CPU reference"):
        TR._check_backend(cfg, torch.device("cuda"))
    with pytest.raises(ValueError, match="backend"):
        TR._check_backend(cfg._replace(backend="pallas"), torch.device("cpu"))
