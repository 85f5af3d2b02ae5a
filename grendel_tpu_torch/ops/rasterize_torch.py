"""Tiled rasterizer in plain PyTorch: the reference the CUDA kernel is held to.

Counterpart of grendel_tpu/ops/rasterize_jax.py, with the same contract:

  * :func:`rasterize_slots` blends an arbitrary set of tile slots, given
    per-slot pixel origins and per-slot entry spans, and returns
    ``(colors (T, P, 3), final_t (T, P))``, pixels row-major in the slot.
    Spans are flat (``tile_offsets``, (T+1,)) or blocked
    (``tile_lo``/``tile_hi``, (T,) each). Entries past ``max_per_tile`` in
    a span are dropped, and ids outside [0, M) are the sentinel.
  * :func:`rasterize_tiles` renders one camera's full tile grid to
    (3, H, W).

The walk is vectorised over slots and pixels and runs entry by entry in
the same order of f32 operations as csrc/rasterize_fwd.cu, so on the card
the two agree up to the few ulps of ``exp``. It is differentiable by
autograd.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .blend import blend_weights, splat_alpha


class RenderAux(NamedTuple):
    final_t: torch.Tensor      # (H, W) or (B, H, W) remaining transmittance
    n_entries: torch.Tensor    # (num_tiles,) or (B, num_tiles) entries per tile
    num_isects: torch.Tensor   # () or (B,) intersections counted by isect


def tile_spans(tile_offsets=None, tile_lo=None, tile_hi=None):
    """(lo, hi) int32 spans from flat offsets or from blocked lo/hi."""
    if tile_lo is None:
        toff = tile_offsets.to(torch.int32)
        return toff[:-1].contiguous(), toff[1:].contiguous()
    return (tile_lo.to(torch.int32).contiguous(),
            tile_hi.to(torch.int32).contiguous())


def slot_pixels(slot_px0, slot_py0, tile_w: int, tile_h: int):
    """(T, P) float pixel coordinates of each slot, row-major in the slot."""
    idx = torch.arange(tile_w * tile_h, device=slot_px0.device)
    lx = (idx % tile_w).to(torch.float32)
    ly = (idx // tile_w).to(torch.float32)
    px = slot_px0.to(torch.float32)[:, None] + lx[None, :]
    py = slot_py0.to(torch.float32)[:, None] + ly[None, :]
    return px, py


def rasterize_slots(
    means2d: torch.Tensor,       # (M, 2)
    conics: torch.Tensor,        # (M, 3)
    colors: torch.Tensor,        # (M, 3)
    opacities: torch.Tensor,     # (M,)
    gauss_ids: torch.Tensor,     # (capacity,) entry -> index into the M arrays
    tile_offsets: torch.Tensor = None,   # (T + 1,) flat spans
    slot_px0: torch.Tensor = None,       # (T,)
    slot_py0: torch.Tensor = None,       # (T,)
    tile_w: int = 16,
    tile_h: int = 16,
    max_per_tile: int = 1024,
    chunk: int = 64,
    *,
    tile_lo: torch.Tensor = None,        # (T,) blocked spans
    tile_hi: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blend every tile slot front to back. See the module docstring."""
    lo, hi = tile_spans(tile_offsets, tile_lo, tile_hi)
    lo, hi = lo.long(), hi.long()
    hi_eff = torch.minimum(hi, lo + max_per_tile)
    dev = means2d.device
    t_slots = lo.shape[0]
    p = tile_w * tile_h
    m = means2d.shape[0]
    cap = gauss_ids.shape[0]
    px, py = slot_pixels(slot_px0, slot_py0, tile_w, tile_h)

    t = torch.ones(t_slots, p, dtype=torch.float32, device=dev)
    done = torch.zeros(t_slots, p, dtype=torch.bool, device=dev)
    color = torch.zeros(t_slots, p, 3, dtype=torch.float32, device=dev)
    n_steps = int((hi_eff - lo).clamp(min=0).max()) if t_slots else 0
    steps = torch.arange(chunk, device=dev)
    for c0 in range(0, n_steps, chunk):
        k = lo[:, None] + c0 + steps                          # (T, K)
        valid = k < hi_eff[:, None]
        ids = gauss_ids[k.clamp(0, cap - 1)].long()
        valid = valid & (ids >= 0) & (ids < m)
        ids = torch.where(valid, ids, torch.zeros_like(ids))
        xy = means2d[ids]                                     # (T, K, 2)
        o = torch.where(valid, opacities[ids], torch.zeros_like(xy[..., 0]))
        dx = px[:, None, :] - xy[..., 0:1]                    # (T, K, P)
        dy = py[:, None, :] - xy[..., 1:2]
        alphas = splat_alpha(dx, dy, conics[ids], o)
        w, t, done = blend_weights(alphas, t, done)
        rgb = colors[ids]                                     # (T, K, 3)
        for j in range(w.shape[1]):
            color = color + w[:, j, :, None] * rgb[:, j, None, :]
        if bool(done.all()):
            break
    return color, t


def slots_to_images(colors: torch.Tensor, t_final: torch.Tensor, n_cams: int,
                    tiles_y: int, tiles_x: int, tile_h: int, tile_w: int,
                    img_h: int, img_w: int):
    """(B*tiles, P, 3) slot colors and (B*tiles, P) transmittance ->
    images (B, 3, H, W) and final_t (B, H, W), tile padding cropped."""
    b, th, tw = n_cams, tile_h, tile_w
    img = colors.reshape(b, tiles_y, tiles_x, th, tw, 3)
    img = img.permute(0, 1, 3, 2, 4, 5).reshape(b, tiles_y * th,
                                                tiles_x * tw, 3)
    img = img[:, :img_h, :img_w].permute(0, 3, 1, 2)
    tmap = t_final.reshape(b, tiles_y, tiles_x, th, tw)
    tmap = tmap.permute(0, 1, 3, 2, 4).reshape(b, tiles_y * th, tiles_x * tw)
    return img, tmap[:, :img_h, :img_w]


def rasterize_tiles(splats, isect, img_h: int, img_w: int, tile_w: int = 16,
                    tile_h: int = 16, bg: torch.Tensor | None = None,
                    max_per_tile: int = 4096, chunk: int = 64):
    """Render one camera from per-tile entry lists (flat ``isect``).

    Returns (image (3, H, W), RenderAux)."""
    dev = splats.means2d.device
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
    tiles_x = -(-img_w // tile_w)
    tiles_y = -(-img_h // tile_h)
    t_ids = torch.arange(tiles_x * tiles_y, dtype=torch.int32, device=dev)
    colors, t_final = rasterize_slots(
        splats.means2d, splats.conics, splats.colors, splats.opacities,
        isect.gauss_ids, isect.tile_offsets, (t_ids % tiles_x) * tile_w,
        (t_ids // tiles_x) * tile_h, tile_w, tile_h, max_per_tile, chunk)
    colors = colors + t_final[..., None] * bg[None, None, :]
    img, tmap = slots_to_images(colors, t_final, 1, tiles_y, tiles_x,
                                tile_h, tile_w, img_h, img_w)
    aux = RenderAux(final_t=tmap[0],
                    n_entries=isect.tile_offsets[1:] - isect.tile_offsets[:-1],
                    num_isects=isect.num_isects)
    return img[0], aux
