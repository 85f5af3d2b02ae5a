"""Tiled rasterizer in plain PyTorch: the reference the CUDA kernel is held to.

Counterpart of grendel_tpu/ops/rasterize_jax.py, with the same contract:

  * :func:`rasterize_slots` blends an arbitrary set of tile slots, given
    per-slot pixel origins and per-slot entry spans, and returns
    ``(colors (T, P, 3), final_t (T, P))``, pixels row-major in the slot.
    Spans are flat (``tile_offsets``, (T+1,)) or blocked
    (``tile_lo``/``tile_hi``, (T,) each). Entries past ``max_per_tile`` in
    a span are dropped, and ids outside [0, M) are the sentinel.
  * :func:`rasterize_slots_bwd` is its vector-Jacobian product, written
    out (no autograd): :func:`rasterize_slots_bwd_rows`, the plain version
    of kernel K2, gives each entry's row of 9 gradients, and
    :func:`segment_sum_rows`, the plain version of kernel K2s, sums them
    per Gaussian in entry order.
  * :func:`rasterize_tiles` renders one camera's full tile grid to
    (3, H, W).

The walk is vectorised over slots and pixels and runs entry by entry in
the same order of f32 operations as csrc/rasterize_fwd.cu, so on the card
the two agree up to the few ulps of ``exp``. The forward is differentiable
by autograd, which keeps (T, K, P) tensors for every chunk of entries: use
that for small scenes only, and :func:`rasterize_slots_bwd` otherwise.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .blend import ALPHA_CLAMP, ALPHA_MIN, T_EPS, blend_weights, splat_alpha


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


def _chunk_ids(gauss_ids, lo, hi_eff, c0: int, steps, m: int):
    """Gaussian ids (T, K) of span entries [lo + c0, lo + c0 + K) and their
    validity: inside the capped span and not the sentinel. Invalid entries
    read Gaussian 0."""
    k = lo[:, None] + c0 + steps                              # (T, K)
    valid = k < hi_eff[:, None]
    ids = gauss_ids[k.clamp(0, gauss_ids.shape[0] - 1)].long()
    valid = valid & (ids >= 0) & (ids < m)
    return torch.where(valid, ids, torch.zeros_like(ids)), valid


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
    px, py = slot_pixels(slot_px0, slot_py0, tile_w, tile_h)

    t = torch.ones(t_slots, p, dtype=torch.float32, device=dev)
    done = torch.zeros(t_slots, p, dtype=torch.bool, device=dev)
    color = torch.zeros(t_slots, p, 3, dtype=torch.float32, device=dev)
    n_steps = int((hi_eff - lo).clamp(min=0).max()) if t_slots else 0
    steps = torch.arange(chunk, device=dev)
    for c0 in range(0, n_steps, chunk):
        ids, valid = _chunk_ids(gauss_ids, lo, hi_eff, c0, steps, m)
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


def segment_sum_rows(rows: torch.Tensor, ids: torch.Tensor,
                     m: int) -> torch.Tensor:
    """(M, C): row g is the sum of the rows of ``rows`` (E, C) whose ``ids``
    (E,) equal g; ids outside [0, M) (the sentinel) are dropped. The plain
    version of kernel K2s (csrc/segment_sum.cu). On the CPU ``index_add_``
    adds the rows one after another in entry order into a zero row, the
    order in which K2s sums them, so the two agree bit for bit."""
    ids = ids.long()
    seg = torch.where((ids >= 0) & (ids < m), ids, torch.full_like(ids, m))
    out = rows.new_zeros(m + 1, rows.shape[1])
    out.index_add_(0, seg, rows)
    return out[:m]


def rasterize_slots_bwd(
    means2d, conics, colors, opacities, gauss_ids, tile_offsets=None,
    slot_px0=None, slot_py0=None, tile_w: int = 16, tile_h: int = 16,
    max_per_tile: int = 1024, chunk: int = 64, *, tile_lo=None,
    tile_hi=None, c_total, final_t, g, g_t,
):
    """Vector-Jacobian product of :func:`rasterize_slots`, written out.

    ``c_total`` (T, P, 3) and ``final_t`` (T, P) are the forward's outputs
    (colors before any background); ``g`` (T, P, 3) and ``g_t`` (T, P) the
    cotangents of those outputs. Returns (d_means2d (M, 2), d_conics (M, 3),
    d_colors (M, 3), d_opacities (M,)), summed over entries per Gaussian
    (:func:`segment_sum_rows` of :func:`rasterize_slots_bwd_rows`); sentinel
    entries contribute nothing. It uses no autograd."""
    rows = rasterize_slots_bwd_rows(
        means2d, conics, colors, opacities, gauss_ids, tile_offsets,
        slot_px0, slot_py0, tile_w, tile_h, max_per_tile, chunk,
        tile_lo=tile_lo, tile_hi=tile_hi, c_total=c_total, final_t=final_t,
        g=g, g_t=g_t)
    d_all = segment_sum_rows(rows, gauss_ids, means2d.shape[0])
    return d_all[:, 0:2], d_all[:, 2:5], d_all[:, 5:8], d_all[:, 8]


def rasterize_slots_bwd_rows(
    means2d, conics, colors, opacities, gauss_ids, tile_offsets=None,
    slot_px0=None, slot_py0=None, tile_w: int = 16, tile_h: int = 16,
    max_per_tile: int = 1024, chunk: int = 64, *, tile_lo=None,
    tile_hi=None, c_total, final_t, g, g_t,
):
    """Each entry's gradients, (E, 9) for the E entries of ``gauss_ids``:
    d_means2d (2), d_conics (3), d_colors (3), d_opacity (1), summed over
    the pixels of the entry's slot. Rows of entries no span reaches, past
    ``max_per_tile``, or with the sentinel id are zero. The arguments are
    :func:`rasterize_slots_bwd`'s; spans must not overlap.

    The walk repeats the forward's f32 operations entry by entry, so each
    pixel stops where the forward stopped, and carries the prefix
    s_i = sum_{j<=i} w_j (g . c_j) to differentiate through later entries
    (grendel_tpu/ops/rasterize_pallas.py:335-384):

        dalpha_i = T_i (g . c_i) - (g . c_total - s_i + T_fin g_t) / (1 - alpha_i)

    zero for entries the forward did not blend and where alpha was clamped
    (o exp(power) >= 0.99). This is the plain version of kernel K2
    (csrc/rasterize_bwd.cu), and the counterpart of the reference's
    per-entry ``d_entries`` (rasterize_pallas.py:629).
    """
    lo, hi = tile_spans(tile_offsets, tile_lo, tile_hi)
    lo, hi = lo.long(), hi.long()
    hi_eff = torch.minimum(hi, lo + max_per_tile)
    dev = means2d.device
    t_slots = lo.shape[0]
    p = tile_w * tile_h
    m = means2d.shape[0]
    px, py = slot_pixels(slot_px0, slot_py0, tile_w, tile_h)
    g_r, g_g, g_b = g[..., 0], g[..., 1], g[..., 2]            # (T, P)
    ctg = c_total[..., 0] * g_r + c_total[..., 1] * g_g + c_total[..., 2] * g_b
    gtt = g_t * final_t

    t = torch.ones(t_slots, p, dtype=torch.float32, device=dev)
    s = torch.zeros(t_slots, p, dtype=torch.float32, device=dev)
    done = torch.zeros(t_slots, p, dtype=torch.bool, device=dev)
    zero = torch.zeros_like(t)
    n_entries = gauss_ids.shape[0]
    rows = torch.zeros(n_entries, 9, dtype=torch.float32, device=dev)
    n_steps = int((hi_eff - lo).clamp(min=0).max()) if t_slots else 0
    steps = torch.arange(chunk, device=dev)
    for c0 in range(0, n_steps, chunk):
        ids, valid = _chunk_ids(gauss_ids, lo, hi_eff, c0, steps, m)
        xy = means2d[ids]                                     # (T, K, 2)
        con = conics[ids]                                     # (T, K, 3)
        rgb = colors[ids]                                     # (T, K, 3)
        o = torch.where(valid, opacities[ids], torch.zeros_like(xy[..., 0]))
        dx = px[:, None, :] - xy[..., 0:1]                    # (T, K, P)
        dy = py[:, None, :] - xy[..., 1:2]
        ca, cb, cc = con[..., 0:1], con[..., 1:2], con[..., 2:3]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        g_exp = torch.exp(power)
        raw = o[..., None] * g_exp
        alpha = raw.clamp(max=ALPHA_CLAMP)
        alpha = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha,
                            torch.zeros_like(alpha))
        unclamped = raw < ALPHA_CLAMP
        ws, das = [], []
        for j in range(alpha.shape[1]):
            a = alpha[:, j]
            gc = (rgb[:, j, None, 0] * g_r + rgb[:, j, None, 1] * g_g
                  + rgb[:, j, None, 2] * g_b)
            t_after = t * (1.0 - a)
            done = done | (t_after < T_EPS)
            blended = ~done & (a > 0.0)
            w = torch.where(blended, a * t, zero)
            s = s + w * gc
            da = t * gc - (ctg - s + gtt) / (1.0 - a)
            das.append(torch.where(blended & unclamped[:, j], da, zero))
            ws.append(w)
            t = torch.where(done, t, t_after)
        w, da = torch.stack(ws, 1), torch.stack(das, 1)       # (T, K, P)
        dp = da * alpha
        per_entry = torch.stack([
            (dp * (ca * dx + cb * dy)).sum(-1),
            (dp * (cc * dy + cb * dx)).sum(-1),
            (dp * (-0.5 * dx * dx)).sum(-1),
            (dp * (-(dx * dy))).sum(-1),
            (dp * (-0.5 * dy * dy)).sum(-1),
            (w * g_r[:, None, :]).sum(-1),
            (w * g_g[:, None, :]).sum(-1),
            (w * g_b[:, None, :]).sum(-1),
            (da * g_exp).sum(-1),
        ], -1)                                                # (T, K, 9)
        pos = lo[:, None] + c0 + steps                        # (T, K)
        keep = valid & (pos < n_entries)
        rows[pos[keep]] = per_entry[keep]
        if bool(done.all()):
            break
    return rows


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
