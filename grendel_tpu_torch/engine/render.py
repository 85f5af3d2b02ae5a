"""Render pipeline: params -> projected splats -> tile lists -> image.

Counterpart of grendel_tpu/engine/render.py. Project the Gaussians for
each camera, build per-tile depth-ordered entry lists, and blend tile by
tile front to back.

``RenderConfig.backend`` picks the blend:

  * ``"cuda"`` (default): the kernel wrappers (ops/rasterize_cuda.py,
    ops/scan_cuda.py). On CUDA tensors they launch the hand-written
    kernels; on CPU tensors they take their plain versions.
    :func:`render_batch` renders the whole camera batch through one
    camera-blocked tile list and one blend launch, as the JAX package's
    single-device trainer does (parallel/sharded.py, blocked branch).
  * ``"torch"``: the plain PyTorch rasterizer, one camera at a time. It is
    a reference for the CPU and refuses CUDA tensors.

Both are differentiable in the parameters: the ``"cuda"`` blend through
its autograd Function (backward kernel K2 on the card), the ``"torch"`` one
by autograd through the plain walk (small scenes only). The tile lists are
integer decisions and are built from detached tensors, so the autograd
graph holds only the projection and the blend inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..cameras import CameraArrays
from ..models.gaussian_model import GaussianParams, activated
from ..ops.isect import (compact_entries_blocked, compact_entries_flat,
                         isect_tile_rows_blocked, isect_tiles)
from ..ops.projection import (ProjectedSplats, project_gaussians,
                              project_gaussians_batched)
from ..ops.rasterize_cuda import rasterize_slots_fwd
from ..ops.rasterize_torch import RenderAux, rasterize_slots, slots_to_images
from ..utils.timer import span

BACKENDS = ("cuda", "torch")


class RenderConfig(NamedTuple):
    """Render-shape configuration."""

    img_h: int
    img_w: int
    tile_w: int = 16
    tile_h: int = 16
    isect_capacity: int = 1 << 18    # tile-list entries per camera
    # post-cull blend budget per camera (0 = isect_capacity: no compaction)
    blend_capacity: int = 0
    max_per_tile: int = 2048
    chunk: int = 64                  # entries per step of the plain walk
    backend: str = "cuda"            # "cuda" | "torch" (CPU only)

    @property
    def blend_cap(self) -> int:
        bb = self.blend_capacity
        if bb <= 0 or bb >= self.isect_capacity:
            return self.isect_capacity
        return bb

    @property
    def tiles_x(self) -> int:
        return -(-self.img_w // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.img_h // self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


def _check_backend(cfg: RenderConfig, device: torch.device) -> None:
    if cfg.backend not in BACKENDS:
        raise ValueError(f"backend {cfg.backend!r}: expected one of {BACKENDS}")
    if cfg.backend == "torch" and device.type != "cpu":
        raise ValueError("backend 'torch' is the plain CPU reference; "
                         "use backend 'cuda' on the card")


def _blend(splats, ids, px0, py0, cfg: RenderConfig, *, tile_offsets=None,
           tile_lo=None, tile_hi=None):
    args = (splats.means2d, splats.conics, splats.colors, splats.opacities,
            ids, tile_offsets, px0, py0, cfg.tile_w, cfg.tile_h,
            cfg.max_per_tile)
    if cfg.backend == "cuda":
        return rasterize_slots_fwd(*args, tile_lo=tile_lo, tile_hi=tile_hi)
    return rasterize_slots(*args, cfg.chunk, tile_lo=tile_lo, tile_hi=tile_hi)


def _slot_origins(n_slots: int, cfg: RenderConfig, device):
    """Pixel origins of ``n_slots`` tile slots, camera-major, row-major."""
    s = torch.arange(n_slots, dtype=torch.int32, device=device)
    px0 = (s % cfg.tiles_x) * cfg.tile_w
    py0 = ((s // cfg.tiles_x) % cfg.tiles_y) * cfg.tile_h
    return px0, py0


def render_splats(splats: ProjectedSplats, cfg: RenderConfig,
                  bg: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, RenderAux]:
    """Rasterize already-projected splats of one camera.

    Returns (image (3, H, W), RenderAux)."""
    dev = splats.means2d.device
    _check_backend(cfg, dev)
    with span("tile lists"):
        isect = isect_tiles(splats.means2d.detach(), splats.radii,
                            splats.depths.detach(), cfg.tile_w, cfg.tile_h,
                            cfg.tiles_x, cfg.tiles_y,
                            capacity=cfg.isect_capacity,
                            opacities=splats.opacities.detach())
        ids, toff = isect.gauss_ids, isect.tile_offsets
        if cfg.blend_cap < cfg.isect_capacity:
            ids, toff = compact_entries_flat(ids, toff, cfg.blend_cap)
    with span("blend"):
        if bg is None:
            bg = torch.zeros(3, dtype=torch.float32, device=dev)
        px0, py0 = _slot_origins(cfg.num_tiles, cfg, dev)
        colors, t_final = _blend(splats, ids, px0, py0, cfg,
                                 tile_offsets=toff)
        colors = colors + t_final[..., None] * bg[None, None, :]
        img, tmap = slots_to_images(colors, t_final, 1, cfg.tiles_y,
                                    cfg.tiles_x, cfg.tile_h, cfg.tile_w,
                                    cfg.img_h, cfg.img_w)
        aux = RenderAux(
            final_t=tmap[0],
            n_entries=isect.tile_offsets[1:] - isect.tile_offsets[:-1],
            num_isects=isect.num_isects)
        return img[0], aux


def render_image(params: GaussianParams, alive: torch.Tensor,
                 cam: CameraArrays, sh_degree: int, cfg: RenderConfig,
                 bg: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, RenderAux]:
    """Render one camera view of the model. Returns (image (3,H,W), aux)."""
    with span("projection"):
        act = activated(params)
        splats = project_gaussians(
            act.means3d, act.scales, act.quats, act.opacities, act.sh, alive,
            cam.viewmat, cam.full_proj, cam.campos, cam.tanfov,
            cfg.img_h, cfg.img_w, sh_degree)
    return render_splats(splats, cfg, bg=bg)


def _render_batch_rowslots(splats: ProjectedSplats, cfg: RenderConfig, bg):
    """The whole batch through one tile list and one blend launch.

    The (B*N) entry universe is camera-major and the entry list is
    camera-blocked: ``cfg.isect_capacity`` entries per camera at fixed
    offsets, each camera with its own overflow budget."""
    b, n = splats.means2d.shape[:2]
    dev = splats.means2d.device
    numt = cfg.num_tiles
    with span("tile lists"):
        flat = ProjectedSplats(*(x.reshape((b * n,) + x.shape[2:])
                                 for x in splats))
        isect = isect_tile_rows_blocked(
            flat.means2d.detach(), flat.radii, flat.depths.detach(), b,
            cfg.tile_w, cfg.tile_h, cfg.tiles_x, cfg.tiles_y,
            capacity=b * cfg.isect_capacity,
            opacities=flat.opacities.detach())
        ids, tlo, thi = isect.gauss_ids, isect.tile_lo, isect.tile_hi
        if cfg.blend_cap < cfg.isect_capacity:
            ids, tlo, thi = compact_entries_blocked(
                ids, tlo, thi, b, numt, cfg.isect_capacity, cfg.blend_cap)
    with span("blend"):
        if bg is None:
            bg = torch.zeros(3, dtype=torch.float32, device=dev)
        px0, py0 = _slot_origins(b * numt, cfg, dev)
        colors, t_final = _blend(flat, ids, px0, py0, cfg, tile_lo=tlo,
                                 tile_hi=thi)
        colors = colors + t_final[..., None] * bg[None, None, :]
        img, tmap = slots_to_images(colors, t_final, b, cfg.tiles_y,
                                    cfg.tiles_x, cfg.tile_h, cfg.tile_w,
                                    cfg.img_h, cfg.img_w)
        aux = RenderAux(
            final_t=tmap,
            n_entries=(isect.tile_hi - isect.tile_lo).reshape(b, numt),
            num_isects=isect.num_isects.expand(b))
        return img, aux


def render_batch(params: GaussianParams, alive: torch.Tensor,
                 cams: CameraArrays, sh_degree: int, cfg: RenderConfig,
                 bg: Optional[torch.Tensor] = None,
                 means2d_tap: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, ProjectedSplats, RenderAux]:
    """Render a batch of cameras (``cams`` with a leading (B,) axis).

    ``means2d_tap`` ((B, N, 2) zeros) is added to the projected means after
    projection and before the tile lists, so a caller that differentiates
    with respect to it reads d(loss)/d(means2d) per camera, which the
    densify statistics need (the reference's ``means2D.retain_grad()``).

    Returns (images (B,3,H,W), batched splats (B,N,...), batched aux); the
    splats' means include the tap."""
    dev = params.means3d.device
    _check_backend(cfg, dev)
    with span("projection"):
        act = activated(params)
        splats = project_gaussians_batched(
            act.means3d, act.scales, act.quats, act.opacities, act.sh, alive,
            cams, cfg.img_h, cfg.img_w, sh_degree)
        if means2d_tap is not None:
            splats = splats._replace(means2d=splats.means2d + means2d_tap)
    if cfg.backend == "cuda":
        img, aux = _render_batch_rowslots(splats, cfg, bg)
        return img, splats, aux
    per_cam = [render_splats(ProjectedSplats(*(x[i] for x in splats)), cfg, bg)
               for i in range(splats.means2d.shape[0])]
    with span("blend"):
        img = torch.stack([im for im, _ in per_cam])
        aux = RenderAux(*(torch.stack(x)
                          for x in zip(*(a for _, a in per_cam))))
        return img, splats, aux
