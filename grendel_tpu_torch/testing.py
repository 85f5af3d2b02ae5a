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
    training set-up.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .cameras import Camera, CameraArrays, batch_camera_arrays, camera_arrays
from .config import OptimizationConfig
from .device import DEFAULT_DEVICE, resolve_device
from .engine.render import RenderConfig
from .engine.train import (TrainState, XyzLrSchedule, train_state_init,
                           train_step)
from .models.gaussian_model import GaussianParams, activated
from .models.optimizer import LrConfig, scaled_lrs
from .ops.isect import isect_tiles
from .ops.projection import project_gaussians
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
    act = activated(scene.params)
    ca0 = camera_arrays(scene.cameras[0], dev)
    with torch.no_grad():
        s0 = project_gaussians(act.means3d, act.scales, act.quats,
                               act.opacities, act.sh, scene.alive,
                               ca0.viewmat, ca0.full_proj, ca0.campos,
                               ca0.tanfov, scene.img_h, scene.img_w,
                               scene.sh_degree)
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
