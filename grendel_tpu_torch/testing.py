"""Synthetic scenes, cameras and training set-ups for tests, benchmarks and
the chip smoke run.

Counterpart of the scene helpers of grendel_tpu/testing.py. Random draws
come from numpy (``np.random.default_rng(seed)``), so a test can hand the
very same values to both packages; the distributions match the JAX
package's, its random bits cannot be reproduced.

  * :func:`garden_scene` / :func:`garden_training`: the garden-scale
    benchmark (bench.py), the render and the training step at full width;
  * :func:`flagship_inputs` / :func:`flagship_training`: the small flagship
    scene of __graft_entry__.py, as numpy for both packages and as a port
    training set-up;
  * :class:`SyntheticScene` and :class:`StructuredSyntheticScene`: the
    scenes the training loop trains on (``Scene``'s duck type), a random
    Gaussian scene rendered to its ground truth, and the raytraced
    hemisphere-rig scene with a held-out split;
  * :func:`simulate_distributed`, :func:`gloo_worker`,
    :func:`trainer_worker` and :func:`storage_worker`: the distributed step
    of D ranks in one process, and one rank of a gloo run of the step, of
    the training loop, or of the loop under distributed dataset storage,
    for the multi-device tests.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .cameras import Camera, CameraArrays, batch_camera_arrays, camera_arrays
from .config import OptimizationConfig
from .data.readers import PointCloud
from .device import DEFAULT_DEVICE, resolve_device
from .engine.render import RenderConfig, render_image
from .engine.train import (TrainState, XyzLrSchedule, train_state_init,
                           train_step)
from .models.gaussian_model import GaussianParams, round_capacity
from .models.optimizer import LrConfig, scaled_lrs
from .ops.isect import isect_tiles
from .ops.projection import ProjectedSplats, project_params
from .ops.sh import rgb_to_sh
from .utils.hbm import mantissa_round_cap

# the garden benchmark's tile geometry and per-tile depth cutoff
# (bench.py: 32x16 tiles, 1024 entries per 256 pixels)
GARDEN_TILE_W, GARDEN_TILE_H, GARDEN_MAX_PER_TILE = 32, 16, 2048


def make_test_camera(width: int = 64, height: int = 48, dist: float = 4.0,
                     fovx: float = 1.0, angle: float = 0.0) -> Camera:
    """Camera on a circle of radius ``dist`` in the xz-plane looking at origin."""
    # w2c: rotate by -angle about y, then translate back by dist along z
    ca, sa = np.cos(angle), np.sin(angle)
    R_w2c = np.array([[ca, 0, -sa], [0, 1, 0], [sa, 0, ca]], dtype=np.float64)
    t_w2c = np.array([0.0, 0.0, dist])
    fovy = 2 * np.arctan(np.tan(fovx / 2) * height / width)
    return Camera(
        uid=0, image_name=f"test_{angle:.2f}",
        R=R_w2c.T, T=t_w2c, fovx=fovx, fovy=float(fovy),
        width=width, height=height,
    )


def random_gaussians(seed: int, n: int, extent: float = 1.5,
                     sh_degree: int = 3, scale_range=(-4.5, -2.5),
                     opacity_range=(0.3, 0.95)):
    """Random Gaussians centered at the origin, activated form, as float32
    numpy arrays: (means (n,3), scales (n,3), quats (n,4), opacities (n,),
    sh (n,K,3))."""
    rng = np.random.default_rng(seed)
    k_sh = (sh_degree + 1) ** 2
    means = rng.uniform(-extent, extent, (n, 3))
    scales = np.exp(rng.uniform(scale_range[0], scale_range[1], (n, 3)))
    quats = rng.standard_normal((n, 4))
    opac = rng.uniform(opacity_range[0], opacity_range[1], n)
    sh = np.zeros((n, k_sh, 3))
    sh[:, 0, :] = rgb_to_sh(rng.uniform(0.1, 0.9, (n, 3)))
    sh[:, 1:, :] = 0.05 * rng.standard_normal((n, k_sh - 1, 3))
    f32 = lambda x: x.astype(np.float32)
    return f32(means), f32(scales), f32(quats), f32(opac), f32(sh)


def jax_random_gaussians(seed: int, n: int, extent: float = 1.5,
                         sh_degree: int = 3, scale_range=(-4.5, -2.5),
                         opacity_range=(0.3, 0.95)):
    """The JAX package's ``random_gaussians(jax.random.PRNGKey(seed),
    ...)``, drawn with utils/prng.py: :func:`random_gaussians`'s arrays,
    with the JAX package's draws (the uniforms bit for bit, the normals to
    a few ulp, the scales through float32 ``exp``)."""
    from .utils import prng

    ks = [prng.fold_in(prng.key(seed), i) for i in range(6)]
    k_sh = (sh_degree + 1) ** 2
    means = prng.uniform(ks[0], (n, 3), -extent, extent, "cpu")
    scales = torch.exp(prng.uniform(ks[1], (n, 3), *scale_range, "cpu"))
    quats = prng.normal(ks[2], (n, 4), "cpu")
    opac = prng.uniform(ks[3], (n,), *opacity_range, "cpu")
    sh = torch.zeros((n, k_sh, 3))
    sh[:, 0, :] = rgb_to_sh(prng.uniform(ks[4], (n, 3), 0.1, 0.9, "cpu"))
    sh[:, 1:, :] = 0.05 * prng.normal(ks[5], (n, k_sh - 1, 3), "cpu")
    return tuple(x.numpy() for x in (means, scales, quats, opac, sh))


def params_fields(means, scales, quats, opac, sh, capacity: int):
    """Raw GaussianParams fields (numpy) of activated Gaussians padded to
    ``capacity``, and the alive mask; the same padding as the JAX
    package's benchmark and flagship scenes."""
    n = means.shape[0]
    pad = capacity - n
    if pad < 0:
        raise ValueError(f"{n} Gaussians exceed capacity {capacity}")

    def padn(x, fill=0.0):
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1),
                      constant_values=fill).astype(np.float32)

    o = np.clip(opac, 1e-4, 1 - 1e-4)
    quats_p = padn(quats)
    quats_p[n:, 0] = 1.0
    fields = dict(
        means3d=padn(means),
        sh_dc=padn(sh[:, :1, :]),
        sh_rest=padn(sh[:, 1:, :]),
        scales_raw=padn(np.log(scales), fill=-10.0),
        quats=quats_p,
        opacities_raw=padn(np.log(o / (1.0 - o)), fill=-10.0),
    )
    return fields, np.arange(capacity) < n


class Scene(NamedTuple):
    params: GaussianParams
    alive: torch.Tensor
    cameras: List[Camera]
    img_h: int
    img_w: int
    sh_degree: int


def garden_scene(seed: int = 0, device=DEFAULT_DEVICE, n_live: int = 200_000,
                 capacity: int = 262_144, bsz: int = 2) -> Scene:
    """The garden-scale benchmark scene (bench.py): 1296x840 pixels,
    200,000 live Gaussians in a capacity of 262,144, SH degree 3, extent
    3.0, log-scales in (-5.5, -3.5), and ``bsz`` cameras at distance 5."""
    from .convert import params_from_numpy

    dev = resolve_device(device)
    h, w, sh_degree = 840, 1296, 3
    g = random_gaussians(seed, n_live, extent=3.0, sh_degree=sh_degree,
                         scale_range=(-5.5, -3.5))
    params, alive = params_from_numpy(*params_fields(*g, capacity), dev)
    cams = [make_test_camera(w, h, dist=5.0, angle=0.1 * i) for i in range(bsz)]
    return Scene(params, alive, cams, h, w, sh_degree)


def garden_render_config(scene: Scene):
    """The garden scene's RenderConfig, with the entry capacities sized as
    bench.py sizes them: camera 0's intersection count probed at a capacity
    of 2^23, 1.15x headroom, mantissa-rounded, and the post-cull blend
    budget likewise from the kept count. Returns (cfg, n_isect, n_kept)."""
    dev = scene.alive.device
    tw, th = GARDEN_TILE_W, GARDEN_TILE_H
    cam0 = batch_camera_arrays(scene.cameras[:1], dev)
    with torch.no_grad():
        s0 = ProjectedSplats(*(x[0] for x in project_params(
            scene.params, scene.alive, cam0, scene.img_h, scene.img_w,
            scene.sh_degree)))
        probe = isect_tiles(s0.means2d, s0.radii, s0.depths, tw, th,
                            -(-scene.img_w // tw), -(-scene.img_h // th),
                            1 << 23, opacities=s0.opacities)
    n_isect, n_kept = int(probe.num_isects), int(probe.num_kept)
    isect_cap = mantissa_round_cap(1.15 * n_isect)
    blend_cap = min(mantissa_round_cap(1.15 * n_kept), isect_cap)
    cfg = RenderConfig(img_h=scene.img_h, img_w=scene.img_w, tile_w=tw,
                       tile_h=th, isect_capacity=isect_cap,
                       blend_capacity=blend_cap,
                       max_per_tile=GARDEN_MAX_PER_TILE)
    return cfg, n_isect, n_kept


class BlendInputs(NamedTuple):
    """The blend's inputs as ``render_batch`` builds them for a batch of
    cameras: ``args`` and ``kw`` for ``rasterize_slots_fwd`` (and, with the
    forward's outputs and cotangents added to ``kw``, its VJP), and the
    number of projected splats (B * capacity), the length of the entry
    counts the tile-list build scans."""

    args: tuple
    kw: dict
    n_splats: int


def garden_blend_inputs(params: GaussianParams, alive, scene: Scene,
                        cfg: RenderConfig) -> BlendInputs:
    """The garden's blend inputs for all of ``scene.cameras`` at ``cfg``,
    through the same projection, camera-blocked tile lists and compaction
    as ``engine.render.render_batch``."""
    from .engine.render import _slot_origins
    from .ops.isect import compact_entries_blocked, isect_tile_rows_blocked
    dev = alive.device
    bsz = len(scene.cameras)
    cams = batch_camera_arrays(scene.cameras, dev)
    splats = project_params(params, alive, cams, scene.img_h, scene.img_w,
                            scene.sh_degree)
    n = splats.means2d.shape[0] * splats.means2d.shape[1]
    flat = ProjectedSplats(*(x.reshape((n,) + x.shape[2:]) for x in splats))
    isect = isect_tile_rows_blocked(
        flat.means2d, flat.radii, flat.depths, bsz, cfg.tile_w, cfg.tile_h,
        cfg.tiles_x, cfg.tiles_y, bsz * cfg.isect_capacity,
        opacities=flat.opacities)
    ids, lo, hi = compact_entries_blocked(
        isect.gauss_ids, isect.tile_lo, isect.tile_hi, bsz, cfg.num_tiles,
        cfg.isect_capacity, cfg.blend_cap)
    px0, py0 = _slot_origins(bsz * cfg.num_tiles, cfg, dev)
    args = (flat.means2d, flat.conics, flat.colors, flat.opacities, ids,
            None, px0, py0, cfg.tile_w, cfg.tile_h, cfg.max_per_tile)
    return BlendInputs(args, dict(tile_lo=lo, tile_hi=hi), n)


class Training(NamedTuple):
    """Everything one training step takes, besides the state."""

    state: TrainState
    cams: CameraArrays
    gt_u8: torch.Tensor
    bg: torch.Tensor
    cfg: RenderConfig
    sh_degree: int
    bsz: int
    lambda_dssim: float
    lrs: LrConfig
    xyz_sched: XyzLrSchedule
    lr_scale_mode: str         # the mode lrs were scaled by

    def step(self, state: TrainState):
        """One ``train_step`` from ``state``: (new_state, metrics)."""
        return train_step(state, self.cams, self.gt_u8, self.bg, self.cfg,
                          self.sh_degree, self.bsz, self.lambda_dssim,
                          self.lrs, self.xyz_sched, self.lr_scale_mode)


def training_setup(state: TrainState, cameras: List[Camera], gt_u8, bg,
                   cfg: RenderConfig, sh_degree: int,
                   opt: Optional[OptimizationConfig] = None) -> Training:
    """A Training with the optimizer settings of ``opt`` (default
    ``OptimizationConfig()``), scaled to the batch (len(cameras)) as
    bench.py scales them; the step divides the gradients by bsz as the
    same lr_scale_mode says."""
    dev = state.alive.device
    opt = OptimizationConfig() if opt is None else opt
    bsz = len(cameras)
    lrs, s = scaled_lrs(opt.feature_lr, opt.opacity_lr, opt.scaling_lr,
                        opt.rotation_lr, bsz=bsz,
                        lr_scale_mode=opt.lr_scale_mode)
    sched = XyzLrSchedule(opt.position_lr_init * s, opt.position_lr_final * s,
                          opt.position_lr_delay_mult,
                          opt.position_lr_max_steps)
    return Training(
        state=state, cams=batch_camera_arrays(cameras, dev),
        gt_u8=torch.as_tensor(np.asarray(gt_u8, np.uint8), device=dev),
        bg=torch.as_tensor(np.asarray(bg, np.float32), device=dev),
        cfg=cfg, sh_degree=sh_degree, bsz=bsz, lambda_dssim=opt.lambda_dssim,
        lrs=lrs, xyz_sched=sched, lr_scale_mode=opt.lr_scale_mode)


def garden_training(seed: int = 0, device=DEFAULT_DEVICE,
                    n_live: int = 200_000, capacity: int = 262_144,
                    bsz: int = 2) -> Training:
    """The training step bench.py times, at full width: the garden scene,
    random ground truth (bsz, 3, 840, 1296) uint8 from
    ``np.random.default_rng(seed)``, a black background, the optimizer
    defaults scaled to bsz, the capacities of :func:`garden_render_config`,
    and a fresh TrainState."""
    scene = garden_scene(seed, device, n_live, capacity, bsz)
    cfg, _, _ = garden_render_config(scene)
    rng = np.random.default_rng(seed)
    gt_u8 = rng.integers(0, 255, (bsz, 3, scene.img_h, scene.img_w),
                         dtype=np.uint8)
    return training_setup(train_state_init(scene.params, scene.alive),
                          scene.cameras, gt_u8, np.zeros(3, np.float32),
                          cfg, scene.sh_degree)


class FlagshipInputs(NamedTuple):
    """The flagship scene as numpy, for both packages."""

    fields: dict               # the six GaussianParams fields
    alive: np.ndarray
    cameras: List[Camera]
    gt_u8: np.ndarray          # (bsz, 3, H, W)
    bg: np.ndarray             # (3,) fixed, non-zero
    img_h: int
    img_w: int
    sh_degree: int
    render: dict               # RenderConfig fields besides the image size


def flagship_inputs(seed: int = 0, bsz: int = 2) -> FlagshipInputs:
    """The flagship scene of __graft_entry__.py (capacity 512, 300 live,
    128x160, SH 3) with ``bsz`` cameras and a fixed non-zero background; no
    pixel saturates. The ground truth is a target to train toward: the
    same Gaussians with their means moved by N(0, 0.03^2), rendered on the
    CPU by the plain reference and quantized to uint8."""
    from .convert import params_from_numpy
    from .engine.render import render_batch

    h, w, sh_degree = 128, 160, 3
    fields, alive = params_fields(
        *random_gaussians(seed, 300, sh_degree=sh_degree), 512)
    cams = [make_test_camera(w, h, angle=0.3 * i) for i in range(bsz)]
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    render = dict(tile_w=GARDEN_TILE_W, tile_h=GARDEN_TILE_H,
                  isect_capacity=8192, max_per_tile=512)
    rng = np.random.default_rng(seed + 1)
    target = dict(fields)
    target["means3d"] = (fields["means3d"] + np.where(
        alive[:, None], 0.03 * rng.standard_normal((512, 3)), 0.0)).astype(
            np.float32)
    with torch.no_grad():
        img, _, _ = render_batch(
            *params_from_numpy(target, alive, "cpu"),
            batch_camera_arrays(cams, "cpu"), sh_degree,
            RenderConfig(img_h=h, img_w=w, backend="torch", **render),
            bg=torch.from_numpy(bg))
    gt_u8 = np.round(np.clip(img.numpy(), 0.0, 1.0) * 255.0).astype(np.uint8)
    return FlagshipInputs(fields, alive, cams, gt_u8, bg, h, w, sh_degree,
                          render)


def flagship_training(inputs: FlagshipInputs, device=DEFAULT_DEVICE,
                      state: Optional[TrainState] = None,
                      opt: Optional[OptimizationConfig] = None) -> Training:
    """A port training set-up on ``inputs`` (see :func:`flagship_inputs`),
    from a fresh state or from ``state`` (e.g. carried across by
    convert.train_state_from_numpy), with the optimizer settings ``opt``."""
    from .convert import params_from_numpy

    dev = resolve_device(device)
    f = inputs
    if state is None:
        state = train_state_init(*params_from_numpy(f.fields, f.alive, dev))
    cfg = RenderConfig(img_h=f.img_h, img_w=f.img_w, **f.render)
    return training_setup(state, f.cameras, f.gt_u8, f.bg, cfg, f.sh_degree,
                          opt)


class SyntheticScene:
    """A random Gaussian scene rendered to its ground truth, in
    ``Scene``'s duck type (train_cameras, test_cameras, cameras_extent,
    point_cloud); the scene of ``--synthetic`` training. The Gaussians come
    from :func:`jax_random_gaussians`, so the scene is the JAX package's
    of the same seed (its ground truth up to a rounding here and there),
    the ground truth from
    ``render_image`` on ``device`` with 16x16 tiles, an entry capacity of
    1 << 15 and a black background; ``n_cams + n_test`` cameras on a circle.
    The initial point cloud is noisy samples of the true means."""

    def __init__(self, n_cams: int = 12, n_test: int = 2, width: int = 160,
                 height: int = 120, n_gaussians: int = 400,
                 n_init_points: int = 300, sh_degree: int = 1, seed: int = 0,
                 device=DEFAULT_DEVICE):
        from .convert import params_from_numpy

        dev = resolve_device(device)
        g = jax_random_gaussians(seed, n_gaussians, sh_degree=sh_degree)
        params, alive = params_from_numpy(
            *params_fields(*g, round_capacity(n_gaussians, 256)), dev)
        cfg = RenderConfig(img_h=height, img_w=width, isect_capacity=1 << 15,
                           max_per_tile=512, chunk=64)
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
        cams = []
        total = n_cams + n_test
        for i in range(total):
            cam = make_test_camera(width, height, angle=2 * np.pi * i / total)
            cam.uid = i
            with torch.no_grad():
                img, _ = render_image(params, alive, camera_arrays(cam, dev),
                                      sh_degree, cfg, bg=bg)
            cam.gt_image_u8 = (torch.clamp(img, 0, 1) * 255).to(
                torch.uint8).cpu().numpy()
            cams.append(cam)
        self.train_cameras = cams[:n_cams]
        self.test_cameras = cams[n_cams:]
        self.cameras_extent = 4.0 * 1.1

        rng = np.random.default_rng(seed)
        pts = g[0][rng.integers(0, n_gaussians, n_init_points)]
        pts = pts + rng.normal(scale=0.05, size=pts.shape)
        cols = rng.uniform(0.2, 0.8, (n_init_points, 3))
        self.point_cloud = PointCloud(points=pts.astype(np.float32),
                                      colors=cols.astype(np.float32))


# ---------------------------------------------------------------------------
# The structured synthetic scene: a raytraced textured ground disk and
# textured spheres, lambertian-shaded under a directional light with hard
# shadows, seen by a hemisphere rig of cameras on three interleaved
# elevation rings, every llffhold-th held out. Pure numpy, the same scene
# as grendel_tpu/testing.py's.
# ---------------------------------------------------------------------------


def lookat_camera(pos, target, width: int, height: int, fovx: float = 1.1,
                  uid: int = 0, name: str = "") -> Camera:
    """Camera at ``pos`` looking at ``target``; the w2c rows are the camera
    axes (x right, y image-down, z forward) and world +y is down."""
    pos = np.asarray(pos, np.float64)
    target = np.asarray(target, np.float64)
    f = target - pos
    f = f / np.linalg.norm(f)
    r = np.cross([0.0, 1.0, 0.0], f)
    nr = np.linalg.norm(r)
    if nr <= 1e-6:
        raise ValueError("degenerate look-at: forward parallel to world y")
    r = r / nr
    d = np.cross(f, r)
    R_w2c = np.stack([r, d, f])
    t_w2c = -R_w2c @ pos
    fovy = 2 * np.arctan(np.tan(fovx / 2) * height / width)
    return Camera(uid=uid, image_name=name or f"view_{uid:03d}",
                  R=R_w2c.T, T=t_w2c, fovx=float(fovx), fovy=float(fovy),
                  width=width, height=height)


# (center_xz, radius, texture kind, two palette colors, texture frequency);
# the spheres rest on the ground plane y = _GROUND_Y (world +y is down)
_GROUND_Y = 0.8
_PLANE_RADIUS = 6.0
_LIGHT = np.array([0.35, -0.9, 0.2]) / np.linalg.norm([0.35, -0.9, 0.2])
_STRUCT_SPHERES = [
    ((0.00, 0.00), 0.52, "stripes", (0.85, 0.25, 0.20), (0.95, 0.85, 0.70), 9.0),
    ((1.15, 0.55), 0.38, "checker", (0.20, 0.45, 0.85), (0.90, 0.90, 0.95), 6.0),
    ((-1.05, 0.50), 0.33, "marble", (0.15, 0.60, 0.30), (0.92, 0.95, 0.88), 4.0),
    ((0.65, -0.95), 0.25, "stripes", (0.90, 0.65, 0.15), (0.25, 0.20, 0.45), 14.0),
    ((-0.70, -0.80), 0.22, "dots", (0.75, 0.20, 0.60), (0.95, 0.92, 0.80), 8.0),
    ((0.10, 1.25), 0.18, "marble", (0.30, 0.30, 0.80), (0.85, 0.90, 0.98), 6.0),
    ((-1.50, -0.35), 0.15, "checker", (0.85, 0.45, 0.20), (0.25, 0.25, 0.30), 8.0),
    ((1.60, -0.45), 0.12, "stripes", (0.20, 0.70, 0.70), (0.95, 0.95, 0.95), 16.0),
]


def _sphere_params():
    return [(np.array([cx, _GROUND_Y - r, cz]), r, kind, np.array(c1),
             np.array(c2), freq)
            for (cx, cz), r, kind, c1, c2, freq in _STRUCT_SPHERES]


def _texture_plane(p):
    """Checker with a low-frequency color wash on the ground disk."""
    s = 0.55
    check = ((np.floor(p[:, 0] / s) + np.floor(p[:, 2] / s)) % 2)
    c1 = np.array([0.78, 0.74, 0.66])
    c2 = np.array([0.35, 0.38, 0.42])
    base = np.where(check[:, None] > 0.5, c1, c2)
    wash = 0.5 + 0.5 * np.sin(0.7 * p[:, 0] + 0.9 * p[:, 2])
    tint = np.stack([0.06 * wash, 0.03 * wash, -0.05 * wash], axis=-1)
    return np.clip(base + tint, 0.0, 1.0)


def _texture_sphere(p, center, radius, kind, c1, c2, freq):
    q = (p - center) / radius
    if kind == "stripes":
        t = 0.5 + 0.5 * np.sin(freq * np.arctan2(q[:, 2], q[:, 0]))
    elif kind == "checker":
        u = np.arctan2(q[:, 2], q[:, 0])
        v = np.arccos(np.clip(q[:, 1], -1, 1))
        t = ((np.floor(u * freq / np.pi) + np.floor(v * freq / np.pi)) % 2)
    elif kind == "dots":
        t = (np.sin(freq * q[:, 0]) * np.sin(freq * q[:, 1])
             * np.sin(freq * q[:, 2]) > 0.15).astype(np.float64)
    else:  # marble
        t = 0.5 + 0.5 * np.sin(freq * q[:, 0]
                               + 2.5 * np.sin(2.2 * q[:, 1])
                               + 1.5 * np.sin(3.1 * q[:, 2]))
    return c1[None] * (1 - t[:, None]) + c2[None] * t[:, None]


def _shade(points, normals, albedo, spheres, ambient=0.34, kd=0.62):
    """Lambertian shading under the directional light with hard sphere
    shadows; a shadow keeps some diffuse light."""
    ndl = np.maximum(0.0, normals @ _LIGHT)
    occ = np.zeros(points.shape[0], bool)
    for c, r, *_ in spheres:
        oc = points + 1e-3 * _LIGHT - c
        b = oc @ _LIGHT
        disc = b * b - (np.sum(oc * oc, axis=-1) - r * r)
        occ |= (disc > 0) & (-b + np.sqrt(np.maximum(disc, 0)) > 0) & (-b > 0)
    light = ambient + kd * ndl * np.where(occ, 0.15, 1.0)
    return np.clip(albedo * light[:, None], 0.0, 1.0)


def raytrace_image(cam: Camera, bg=(0.0, 0.0, 0.0)) -> np.ndarray:
    """The structured scene seen by ``cam``: (3, H, W) float32 in [0, 1].
    Rays pass through the pixel centers of the projection's convention,
    so the raytraced ground truth and the rasterized renders agree in
    geometry to below a pixel."""
    h, w = cam.height, cam.width
    spheres = _sphere_params()
    ndc_x = (2 * np.arange(w) + 1) / w - 1
    ndc_y = (2 * np.arange(h) + 1) / h - 1
    dx = (ndc_x * cam.tanfovx)[None, :].repeat(h, 0)
    dy = (ndc_y * cam.tanfovy)[:, None].repeat(w, 1)
    d_cam = np.stack([dx, dy, np.ones_like(dx)], axis=-1).reshape(-1, 3)
    R_w2c = cam.world_view[:3, :3].astype(np.float64)
    d = d_cam @ R_w2c                    # rows are camera axes: R^T @ d_cam
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = cam.camera_center.astype(np.float64)

    n_ray = d.shape[0]
    t_best = np.full(n_ray, np.inf)
    obj = np.full(n_ray, -1, np.int32)   # -1 none, 0..n-1 spheres, 99 plane
    for i, (c, r, *_) in enumerate(spheres):
        b = d @ (o - c)
        q = np.sum((o - c) ** 2) - r * r
        disc = b * b - q
        t = -b - np.sqrt(np.maximum(disc, 0))
        ok = (disc > 0) & (t > 1e-4) & (t < t_best)
        t_best = np.where(ok, t, t_best)
        obj = np.where(ok, i, obj)
    dy_r = d[:, 1]
    tp = (_GROUND_Y - o[1]) / np.where(np.abs(dy_r) < 1e-9, 1e-9, dy_r)
    pp = o[None] + tp[:, None] * d
    in_disk = (tp > 1e-4) & (pp[:, 0] ** 2 + pp[:, 2] ** 2
                             < _PLANE_RADIUS ** 2) & (tp < t_best)
    t_best = np.where(in_disk, tp, t_best)
    obj = np.where(in_disk, 99, obj)

    img = np.tile(np.asarray(bg, np.float64)[None], (n_ray, 1))
    pts = o[None] + t_best[:, None] * d
    m = obj == 99
    if m.any():
        normals = np.tile(np.array([0.0, -1.0, 0.0])[None], (m.sum(), 1))
        img[m] = _shade(pts[m], normals, _texture_plane(pts[m]), spheres)
    for i, (c, r, kind, c1, c2, freq) in enumerate(spheres):
        m = obj == i
        if not m.any():
            continue
        normals = (pts[m] - c) / r
        albedo = _texture_sphere(pts[m], c, r, kind, c1, c2, freq)
        img[m] = _shade(pts[m], normals, albedo, spheres)
    return img.reshape(h, w, 3).transpose(2, 0, 1).astype(np.float32)


def _structured_point_cloud(n_points: int, seed: int) -> PointCloud:
    """An SfM-like initial cloud: noisy surface samples with shaded
    colors, denser toward the center of the ground disk."""
    rng = np.random.default_rng(seed)
    spheres = _sphere_params()
    areas = np.array([4 * np.pi * r * r for _, r, *_ in spheres])
    plane_area = np.pi * 3.6 ** 2          # the camera-visible inner disk
    w_all = np.concatenate([[plane_area], areas])
    counts = (n_points * w_all / w_all.sum()).astype(int)
    pts, cols = [], []
    n_p = counts[0]
    rad = 3.6 * np.sqrt(rng.random(n_p)) * (0.55 + 0.45 * rng.random(n_p))
    az = 2 * np.pi * rng.random(n_p)
    p = np.stack([rad * np.cos(az), np.full(n_p, _GROUND_Y),
                  rad * np.sin(az)], axis=-1)
    nrm = np.tile(np.array([0.0, -1.0, 0.0])[None], (n_p, 1))
    pts.append(p)
    cols.append(_shade(p, nrm, _texture_plane(p), spheres))
    for (center, r, kind, c1, c2, freq), n_s in zip(spheres, counts[1:]):
        u = rng.normal(size=(max(n_s, 8), 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        p = center[None] + r * u
        pts.append(p)
        cols.append(_shade(p, u, _texture_sphere(p, center, r, kind, c1, c2,
                                                 freq), spheres))
    pts = np.concatenate(pts) + rng.normal(scale=0.01,
                                           size=(sum(len(x) for x in pts), 3))
    return PointCloud(points=pts.astype(np.float32),
                      colors=np.concatenate(cols).astype(np.float32))


class StructuredSyntheticScene:
    """The raytraced structured scene in ``Scene``'s duck type: ``n_cams``
    cameras on three interleaved elevation rings of a hemisphere above the
    scene, ordered by azimuth, every ``llffhold``-th held out, so test
    views sit between training views on every ring. With ``raytrace``
    False the cameras carry no ground truth (for a dataset whose images
    were rendered before)."""

    def __init__(self, width: int = 1280, height: int = 832,
                 n_cams: int = 72, llffhold: int = 8,
                 n_init_points: int = 100_000, seed: int = 0,
                 fovx: float = 1.1, raytrace: bool = True):
        target = np.array([0.0, 0.42, 0.0])
        rings = [  # (distance from target, elevation above horizon, share)
            (4.4, np.deg2rad(21.0), 0.5),
            (3.8, np.deg2rad(38.0), 0.333),
            (3.1, np.deg2rad(56.0), 0.167),
        ]
        counts = [max(3, int(round(n_cams * s))) for _, _, s in rings]
        counts[0] += n_cams - sum(counts)
        cams = []
        for k, ((dist, elev, _), cnt) in enumerate(zip(rings, counts)):
            for i in range(cnt):
                # staggered rings, azimuth kept in [0, 2 pi) so the sort
                # below interleaves by true azimuth
                az = 2 * np.pi * ((i / cnt + k * 0.37) % 1.0)
                pos = target + np.array([
                    dist * np.cos(elev) * np.cos(az),
                    -dist * np.sin(elev),               # world -y is up
                    dist * np.cos(elev) * np.sin(az),
                ])
                cams.append((az, pos))
        cams.sort(key=lambda t: t[0])
        cameras = [lookat_camera(pos, target, width, height, fovx=fovx,
                                 uid=uid, name=f"view_{uid:03d}")
                   for uid, (az, pos) in enumerate(cams)]
        # numpy lets go of the interpreter lock in its array passes, so the
        # views raytrace in parallel
        with ThreadPoolExecutor(min(len(cameras), os.cpu_count() or 1)) as ex:
            for cam, img in zip(cameras, ex.map(raytrace_image, cameras)
                                if raytrace else ()):
                cam.gt_image_u8 = np.asarray(
                    np.clip(img, 0, 1) * 255).astype(np.uint8)
        self.test_cameras = [c for i, c in enumerate(cameras)
                             if i % llffhold == 0]
        self.train_cameras = [c for i, c in enumerate(cameras)
                              if i % llffhold != 0]
        centers = np.stack([c.camera_center for c in cameras])
        dists = np.linalg.norm(centers - centers.mean(0), axis=-1)
        self.cameras_extent = float(dists.max() * 1.1)
        self.point_cloud = _structured_point_cloud(n_init_points, seed)


# --------------------------------------------------------------------------
# the distributed step, simulated in one process and run in gloo processes
# --------------------------------------------------------------------------


class SimulatedStep(NamedTuple):
    """What :func:`simulate_distributed` returns."""

    loss: torch.Tensor          # () the global loss
    l1: torch.Tensor            # () summed over ranks
    ssim: torch.Tensor
    grads: GaussianParams       # d(loss)/d(params), the whole capacity
    tap_grad: torch.Tensor      # (B, N, 2) d(loss)/d(means2d)
    radii: torch.Tensor         # (B, N) int32
    images: torch.Tensor        # (B, 3, H, W) assembled from the ranks' rows
    per_rank: list              # each rank's aux (parallel/sharded.py _aux)


def simulate_distributed(params: GaussianParams, alive, cams: CameraArrays,
                         gt_rows_u8, division_pos, bg, cfg, sh_degree: int,
                         lambda_dssim: float,
                         lr_scale_loss: float = 1.0) -> SimulatedStep:
    """The Gaussian-sharded forward and backward of ``cfg.n_devices`` ranks
    in one process: each rank's slice is projected and packed
    (``pack_for_exchange``), the buckets move from rank s to rank r by a
    differentiable index (recv[r] = send[:, r], the all-to-all's effect),
    each rank renders its rows and takes its partial loss, and one backward
    runs over the sum of the partials. ``gt_rows_u8`` is (D, R, 3, tile_h,
    W). Nothing in the package calls this: it runs the flat path of D > 1
    ranks where there is one device (NCCL takes one rank per GPU)."""
    from .parallel import sharded as S

    d_count, bsz = cfg.n_devices, cfg.bsz
    n = alive.shape[0]
    n_loc = n // d_count
    leaves = [p.detach().requires_grad_(True) for p in params]
    tap = torch.zeros((bsz, n, 2), dtype=torch.float32, device=alive.device,
                      requires_grad=True)
    sends, radii = [], []
    for s in range(d_count):
        sl = slice(s * n_loc, (s + 1) * n_loc)
        splats = S.project_batch(GaussianParams(*(x[sl] for x in leaves)),
                                 alive[sl], cams, cfg, sh_degree)
        sends.append(S.pack_for_exchange(
            splats.means2d + tap[:, sl], splats.conics, splats.colors,
            splats.opacities, splats.radii, splats.depths, division_pos, cfg))
        radii.append(splats.radii)
    send_p = torch.stack([x[0] for x in sends])   # (D src, D dst, cap, F)
    send_m = torch.stack([x[1] for x in sends])
    partials, l1s, ssims, per_rank = [], [], [], []
    images = 0.0
    for r in range(d_count):
        lo, hi = division_pos[r], division_pos[r + 1]
        partial, l1_part, ssim_part, own = S.owned_loss(
            send_p[:, r].reshape(-1, S.PAYLOAD_F),
            send_m[:, r].reshape(-1, S.META_F), lo, hi, gt_rows_u8[r], bg,
            cfg, lambda_dssim)
        partials.append(partial)
        l1s.append(l1_part)
        ssims.append(ssim_part)
        images = images + S.rows_to_images(own.rows.detach(), own.mask, lo,
                                           hi, cfg)
        per_rank.append(S._aux(l1_part.detach(), ssim_part.detach(),
                               radii[r], own, sends[r][2], sends[r][3]))
    loss = (torch.stack(partials).sum() + lambda_dssim * bsz) * lr_scale_loss
    *grads, tap_grad = torch.autograd.grad(loss, leaves + [tap])
    return SimulatedStep(loss.detach(), torch.stack(l1s).sum().detach(),
                         torch.stack(ssims).sum().detach(),
                         GaussianParams(*grads), tap_grad,
                         torch.cat(radii, dim=1), images, per_rank)


def gloo_worker(rank: int, world: int, port: int, spec_path: str,
                out_dir: str) -> None:
    """One rank of a CPU run of ``DistributedTrainer`` over gloo, for the
    parity test of the distributed step (tests/test_torch_distributed.py;
    start with ``torch.multiprocessing.spawn``).

    ``spec_path`` is an npz: the six parameter fields and ``alive``, the
    cameras (``cam_angles``, ``img_w``, ``img_h``), ``gt_u8`` (B, 3, H, W),
    ``bg``, ``division_pos`` and a JSON ``spec`` string (ParallelConfig
    fields, learning rates, the xyz schedule, lambda_dssim, sh_degree, the
    densify arguments of each mode). For each distribution mode the rank
    takes one step from a fresh state, renders the initial model and
    densifies the stepped one, and writes what it saw to
    ``out_dir/<mode>_rank<rank>.npz``."""
    import json
    import os

    from .convert import params_from_numpy
    from .parallel import comm
    from .parallel.division import pack_gt_rows
    from .parallel.sharded import DistributedTrainer, ParallelConfig

    comm.join_local(rank, world, port, "cpu")
    try:
        z = np.load(spec_path)
        spec = json.loads(str(z["spec"]))
        fields = {k: z[k] for k in GaussianParams._fields}
        cams = [make_test_camera(int(z["img_w"]), int(z["img_h"]), angle=a)
                for a in z["cam_angles"]]
        cam_arr = batch_camera_arrays(cams, "cpu")
        pos = torch.as_tensor(z["division_pos"], dtype=torch.int32)
        bg = torch.as_tensor(z["bg"])
        for mode in ("sharded", "replicated"):
            cfg = ParallelConfig(**spec["parallel"],
                                 gaussians_distribution=mode == "sharded")
            n = z["alive"].shape[0]
            cfg = cfg.resolved(n // world)
            tr = DistributedTrainer(
                cfg, spec["sh_degree"], spec["lambda_dssim"],
                LrConfig(**spec["lrs"]), XyzLrSchedule(*spec["xyz_sched"]))
            gt_rows = torch.as_tensor(pack_gt_rows(
                cams, z["division_pos"], world, cfg.n_row_slots, cfg.tile_h,
                cfg.img_h, cfg.img_w, gt_override=list(z["gt_u8"]))[rank])
            state = tr.shard_state(train_state_init(
                *params_from_numpy(fields, z["alive"], "cpu")))
            new, m = tr.step(state, cam_arr, gt_rows, pos, bg)
            imgs = tr.render(state.params, state.alive, cam_arr, pos, bg)
            d = spec["densify"][mode]
            _, info = tr.densify(new, 0, d["grad_threshold"],
                                 d["min_opacity"], d["extent"],
                                 d["percent_dense"], d["use_size_prune"])
            out = {f"metric_{k}": v.numpy() for k, v in m.items()}
            for k in GaussianParams._fields:
                out[f"param_{k}"] = getattr(new.params, k).detach().numpy()
                out[f"mu_{k}"] = getattr(new.adam.mu, k).numpy()
                out[f"nu_{k}"] = getattr(new.adam.nu, k).numpy()
            for k in new.stats._fields:
                out[f"stats_{k}"] = getattr(new.stats, k).numpy()
            out.update(images=imgs.numpy(), densify_info=info.numpy())
            np.savez(os.path.join(out_dir, f"{mode}_rank{rank}.npz"), **out)
    finally:
        comm.destroy_group()


def apply_config(cfg, overrides: dict):
    """Set ``overrides`` on a TrainConfig: a dict value sets the fields of
    that section (``{"opt": {"iterations": 8}}``), any other value the
    top-level field. Returns ``cfg.finalize()``."""
    for key, value in overrides.items():
        if isinstance(value, dict):
            for field, v in value.items():
                setattr(getattr(cfg, key), field, v)
        else:
            setattr(cfg, key, value)
    return cfg.finalize()


def trainer_worker(rank: int, world: int, port: int, spec_path: str,
                   out_dir: str) -> None:
    """One rank of a CPU run of the port's training loop over gloo
    (engine/trainer_dist.py ``MultiRankTrainer``), for the
    multi-rank loop's tests (start with ``torch.multiprocessing``).

    ``spec_path`` is an npz: the scene (convert.scene_arrays's arrays:
    ``train_*`` and ``test_*`` cameras, ``points``, ``colors``,
    ``extent``) and a JSON ``spec`` string: ``config``, the
    TrainConfig overrides (:func:`apply_config`; the model path is
    ``out_dir``), and optionally ``memory_fraction`` ({rank: share} that
    replaces the rank's device memory share), ``hbm_gb`` (the device
    memory, set as ``GRENDEL_HBM_GB``), ``step_bytes`` ({rank: [base,
    per_entry]}: the rank's measured step takes base + per_entry x its
    entry capacity) and ``gt_steps`` (the steps whose ground-truth rows
    are kept). The rank writes ``out_dir/rank<rank>.npz``: every step's
    loss and l1 and entry capacity, the JSON records of the run, the
    held-out eval, the kept ground-truth rows with their step's batch and
    division; and logs to ``out_dir/log_rk<rank>.txt``."""
    import json
    import os

    from .config import TrainConfig
    from .convert import scene_from_arrays
    from .engine.trainer_dist import MultiRankTrainer
    from .parallel import comm

    comm.join_local(rank, world, port, "cpu")
    try:
        z = np.load(spec_path)
        spec = json.loads(str(z["spec"]))
        if "hbm_gb" in spec:
            os.environ["GRENDEL_HBM_GB"] = str(spec["hbm_gb"])

        scene = scene_from_arrays(z)
        cfg = apply_config(TrainConfig(), dict(
            spec["config"], model=dict(spec["config"].get("model", {}),
                                       model_path=out_dir)))
        with open(os.path.join(out_dir, f"log_rk{rank}.txt"), "w") as log:
            tr = MultiRankTrainer(cfg, scene, device="cpu", log_file=log)
            frac = spec.get("memory_fraction", {}).get(str(rank))
            if frac is not None:
                tr._memory_fraction = lambda: frac
            reading = spec.get("step_bytes", {}).get(str(rank))
            if reading is not None:
                tr._step_bytes = lambda: int(reading[0] + reading[1]
                                             * tr._isect_cap())
            losses, gt, caps = [], [], []
            real_step, real_rows = tr._step, tr._gt_rows

            def step(*args):
                caps.append(tr._trainer(args[3]).cfg.isect_capacity)
                state, m = real_step(*args)
                losses.append((float(m["loss"]), float(m["l1"])))
                return state, m

            def gt_rows(batch, ids, pos_np, pcfg):
                rows = real_rows(batch, ids, pos_np, pcfg)
                if len(gt) < spec.get("gt_steps", 0):
                    gt.append((ids.numpy(), pos_np, rows.numpy()))
                return rows

            tr._step, tr._gt_rows = step, gt_rows
            tr.train()
            ev = tr.eval_psnr(scene.test_cameras, cfg.model.sh_degree)
            records = dict(
                densify_history=tr.densify_history,
                capacity_events=tr.capacity_events,
                opacity_reset_iters=tr.opacity_reset_iters,
                redistribute_count=tr.redistribute_count,
                n_alive=tr._n_alive(), n_local=tr.n_local,
                iteration=int(tr.state.iteration), eval=ev,
                isect_capacity_ceiling=tr.isect_capacity_ceiling,
                hbm_readings=tr.hbm_readings)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 losses=np.array(losses), records=json.dumps(records),
                 step_caps=np.array(caps),
                 gt_ids=np.array([g[0] for g in gt]),
                 gt_pos=np.array([g[1] for g in gt]),
                 gt_rows=np.array([g[2] for g in gt]))
    finally:
        comm.destroy_group()


def storage_worker(rank: int, world: int, port: int, spec_path: str,
                   out_dir: str) -> None:
    """One rank of a CPU run of the multi-rank loop over gloo under
    ``--distributed_dataset_storage``, for tests/test_torch_gt_storage.py
    (start with ``torch.multiprocessing``).

    ``spec_path`` is a JSON file: ``scene_dir`` (a COLMAP scene),
    ``llffhold`` and ``config`` (TrainConfig overrides, as
    :func:`apply_config` takes them). The rank loads the scene with the
    training CLI's ``make_decode_mask`` (its stride of the cameras decoded
    at load, the rest lazy), then trains it twice from the same seed: at
    preload threshold 0 (the ground truth stays on the host and the rank
    packs its rows) and at 10 GB (the dataset is preloaded). It writes
    ``out_dir/rank<rank>.npz``: the cameras stored at load, the lazy
    decodes at load, each run's L1 history, lazy decodes and whether it
    had a bank, and the preloaded run's bank."""
    import json

    from . import cameras as cam_mod
    from .config import TrainConfig
    from .data.scene import Scene
    from .engine.trainer_dist import MultiRankTrainer
    from .parallel import comm
    from .scripts.train import make_decode_mask

    comm.join_local(rank, world, port, "cpu")
    try:
        with open(spec_path) as f:
            spec = json.load(f)

        def config(threshold, name):
            over = dict(spec["config"])
            over["dist"] = dict(over.get("dist", {}),
                                preload_dataset_to_gpu_threshold=threshold)
            over["model"] = dict(over.get("model", {}),
                                 model_path=os.path.join(
                                     out_dir, f"{name}_rk{rank}"))
            return apply_config(TrainConfig(), over)

        n0 = cam_mod.LAZY_DECODE_COUNT[0]
        scene = Scene(spec["scene_dir"], eval_split=True,
                      llffhold=spec["llffhold"],
                      decode_mask=make_decode_mask(config(0, "host"), world,
                                                   rank))
        out = dict(
            names=[c.image_name for c in scene.train_cameras],
            stored_train=[c.gt_image_u8 is not None
                          for c in scene.train_cameras],
            stored_test=[c.gt_image_u8 is not None
                         for c in scene.test_cameras],
            load_decodes=cam_mod.LAZY_DECODE_COUNT[0] - n0)
        for name, threshold in (("host", 0), ("preloaded", 10)):
            tr = MultiRankTrainer(config(threshold, name), scene,
                                  device="cpu")
            l1s, real_step = [], tr._step

            def step(*args, real_step=real_step, l1s=l1s):
                state, m = real_step(*args)
                l1s.append(float(m["l1"]))
                return state, m

            tr._step = step
            n1 = cam_mod.LAZY_DECODE_COUNT[0]
            tr.train()
            out[f"{name}_l1"] = l1s
            out[f"{name}_decodes"] = cam_mod.LAZY_DECODE_COUNT[0] - n1
            out[f"{name}_has_bank"] = tr._gt_bank is not None
            if tr._gt_bank is not None:
                out["bank"] = tr._gt_bank.numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        comm.destroy_group()
