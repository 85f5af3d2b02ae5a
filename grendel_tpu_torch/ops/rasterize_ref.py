"""Dense reference rasterizer: the correctness oracle, for tests only.

Counterpart of grendel_tpu/ops/rasterize_ref.py. Blends every Gaussian
against every pixel (O(N * H * W) memory) with the same tile-rect gating,
clamping and stop rule as the tiled rasterizers, so on small scenes they
must match it.
"""

from __future__ import annotations

import torch

from .blend import blend_weights, splat_alpha
from .isect import gaussian_tile_rect


def rasterize_dense(splats, img_h: int, img_w: int, tile_w: int = 16,
                    tile_h: int = 16, bg: torch.Tensor | None = None):
    """Returns (image (3, H, W), final_t (H, W))."""
    dev = splats.means2d.device
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
    tiles_x = -(-img_w // tile_w)
    tiles_y = -(-img_h // tile_h)

    order = torch.sort(splats.depths, stable=True).indices
    m2d = splats.means2d[order]
    rgb = splats.colors[order]
    x0, y0, spanx, spany = gaussian_tile_rect(
        m2d, splats.radii[order], tile_w, tile_h, tiles_x, tiles_y)

    py, px = torch.meshgrid(torch.arange(img_h, device=dev),
                            torch.arange(img_w, device=dev), indexing="ij")
    px = px.reshape(-1).to(torch.float32)                # (P,)
    py = py.reshape(-1).to(torch.float32)
    ptx = torch.div(px, tile_w, rounding_mode="floor").to(torch.int32)
    pty = torch.div(py, tile_h, rounding_mode="floor").to(torch.int32)
    in_rect = ((ptx[None, :] >= x0[:, None])
               & (ptx[None, :] < (x0 + spanx)[:, None])
               & (pty[None, :] >= y0[:, None])
               & (pty[None, :] < (y0 + spany)[:, None]))   # (N, P)

    dx = px[None, :] - m2d[:, 0:1]
    dy = py[None, :] - m2d[:, 1:2]
    alphas = splat_alpha(dx, dy, splats.conics[order],
                         splats.opacities[order]) * in_rect
    weights, t_out, _ = blend_weights(
        alphas, torch.ones(px.shape[0], dtype=torch.float32, device=dev))
    color = torch.einsum("np,nc->pc", weights, rgb) + t_out[:, None] * bg[None, :]
    image = color.reshape(img_h, img_w, 3).permute(2, 0, 1)
    return image, t_out.reshape(img_h, img_w)
