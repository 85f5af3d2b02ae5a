"""Tile intersection: per-tile, depth-ordered Gaussian entry lists.

Counterpart of grendel_tpu/ops/isect.py, with results bit-identical to it
on the same projected splats. Entry buffers have a fixed ``capacity``:

  1. sort Gaussians by view depth (culled ones have depth +inf and sort
     last);
  2. per Gaussian, the rect of tiles its 3-sigma box (or its tighter
     opacity-aware cull radius) overlaps, and its entry count;
  3. expand to a flat entry list: per-Gaussian attributes are broadcast
     over their entry segments by a scatter of value deltas at segment
     starts followed by an inclusive int32 scan (kernel K3 on the card,
     ops/scan_cuda.py), as are the entry counts;
  4. stable-sort entries by tile key, so each tile's sublist stays in
     depth order;
  5. per-tile spans by binary search of the sorted keys.

The scatter-delta + scan expansion is the JAX package's structure, kept so
the two agree bit for bit; sorts and searches are PyTorch library calls,
as they were XLA's in the JAX package. Every entry outside the spans (the
tail past the last span, where the corner cull's drops and the unused
capacity sort) carries the sentinel id, the universe size, in every
layout: the backward's segment sum (kernel K2s) then drops them by id.
The JAX package's flat lists leave Gaussian ids in that tail; the entries
inside the spans are the same.

A ``capacity`` of 0 sizes the entry list to the entries there are (per
camera for the blocked lists), which costs one read of the count on the
host; nothing is dropped. The render tool takes lists of that size.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .scan_cuda import cumsum_i32, cumsum_i32_multi

I32 = torch.int32


class TileIntersections(NamedTuple):
    gauss_ids: torch.Tensor     # (capacity,) int32 Gaussian index per
                                # entry; sentinel = universe size
    tile_offsets: torch.Tensor  # (num_tiles + 1,) int32 entry span of tile t
    num_isects: torch.Tensor    # () int32 true total (may exceed capacity)
    num_kept: torch.Tensor      # () int32 entries that survived the corner
                                # cull and clipping (the sorted prefix)


class BlockedTileIntersections(NamedTuple):
    """Camera-blocked entry lists: camera c's entries live at positions
    [c*block, (c+1)*block); padding entries carry the sentinel id (the
    universe size). Spans are separate lo/hi arrays, since a camera's last
    tile ends at its valid-entry count, not at the next block's start."""

    gauss_ids: torch.Tensor     # (capacity,) int32; sentinel = universe size
    tile_lo: torch.Tensor       # (num_slots,) int32
    tile_hi: torch.Tensor       # (num_slots,) int32
    num_isects: torch.Tensor    # () int32 n_cams * max per-camera demand
    num_kept: torch.Tensor      # () int32 n_cams * max per-camera post-cull count


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def _delta_buf(values: torch.Tensor, seg_starts: torch.Tensor,
               capacity: int) -> torch.Tensor:
    """Scatter-add of value deltas at segment starts (the pre-scan half of
    a segment broadcast). Zero-length segments land on the same position
    and telescope through the add; starts at or past ``capacity`` drop
    into a spare slot. int32 adds wrap, in any order."""
    deltas = torch.diff(values, prepend=values.new_zeros(1))
    buf = torch.zeros(capacity + 1, dtype=I32, device=values.device)
    buf.index_add_(0, torch.clamp(seg_starts, max=capacity).long(), deltas)
    return buf[:capacity]


def _segment_broadcast_multi(values_list, seg_starts: torch.Tensor,
                             capacity: int) -> list:
    """out[e] = values[segment containing e] for each of ``values_list``,
    segment i covering [seg_starts[i], seg_starts[i+1]); all channels go
    through one multi-channel scan."""
    return cumsum_i32_multi([_delta_buf(v, seg_starts, capacity)
                             for v in values_list])


def compact_entries_blocked(ids, tlo, thi, n_cams: int, numt: int,
                            bpc: int, bbc: int):
    """Keep each camera block's first ``bbc`` of ``bpc`` entries (the corner
    cull's drops carry the sentinel key and sort to the block tail) and
    shift the tile spans accordingly; spans past the budget clamp."""
    ids = ids.reshape(n_cams, bpc)[:, :bbc].reshape(-1)
    cam_slot = _arange(tlo.shape[0], tlo.device) // numt
    tlo = cam_slot * bbc + torch.clamp(tlo - cam_slot * bpc, 0, bbc)
    thi = cam_slot * bbc + torch.clamp(thi - cam_slot * bpc, 0, bbc)
    return ids, tlo.to(I32), thi.to(I32)


def compact_entries_flat(ids, tile_offsets, bb: int):
    """Flat-axis compaction: survivors are the sorted prefix."""
    return ids[:bb], torch.clamp(tile_offsets, max=bb)


def gaussian_tile_rect(means2d, radii, tile_w: int, tile_h: int,
                       tiles_x: int, tiles_y: int, rect_r=None):
    """Inclusive-exclusive tile rect [x0,x1) x [y0,y1) of each Gaussian's
    box: the reference getRect convention on the integer 3-sigma ``radii``,
    or, with ``rect_r``, the tighter opacity-aware float radius (capped by
    the reference rect; ``rect_r < 0`` gives an empty rect)."""
    mx, my = means2d[:, 0], means2d[:, 1]
    if rect_r is None:
        r = radii.to(torch.float32)
        x1 = torch.clamp(torch.floor((mx + r + tile_w - 1) / tile_w), 0, tiles_x)
        y1 = torch.clamp(torch.floor((my + r + tile_h - 1) / tile_h), 0, tiles_y)
    else:
        r = rect_r
        rr = radii.to(torch.float32)
        x1 = torch.minimum(torch.floor((mx + r) / tile_w) + 1,
                           torch.floor((mx + rr + tile_w - 1) / tile_w))
        y1 = torch.minimum(torch.floor((my + r) / tile_h) + 1,
                           torch.floor((my + rr + tile_h - 1) / tile_h))
        x1 = torch.clamp(x1, 0, tiles_x)
        y1 = torch.clamp(y1, 0, tiles_y)
    x0 = torch.clamp(torch.floor((mx - r) / tile_w), 0, tiles_x).to(I32)
    y0 = torch.clamp(torch.floor((my - r) / tile_h), 0, tiles_y).to(I32)
    x1, y1 = x1.to(I32), y1.to(I32)
    visible = radii > 0
    if rect_r is not None:
        visible = visible & (rect_r >= 0.0)
    zero = torch.zeros_like(x0)
    spanx = torch.where(visible, x1 - x0, zero)
    spany = torch.where(visible, y1 - y0, zero)
    return x0, y0, spanx, spany


def cull_radius(radii, opacities):
    """Opacity-aware cull radius: beyond it alpha is provably below the
    blend threshold 1/255 (alpha(d) <= op * exp(-0.5 d^2 / lam_max), with
    sqrt(lam_max) <= radius / 3), so dropping those entries cannot change
    the output. -1 marks a Gaussian whose peak alpha is already below the
    threshold. Unclipped: the caller clips it to ``radii`` for the rect."""
    r = radii.to(torch.float32)
    ln = torch.log(torch.clamp(255.0 * opacities, min=1e-30))
    rc = (r * (1.0 / 3.0)) * torch.sqrt(2.0 * torch.clamp(ln, min=0.0)) * 1.0001
    return torch.where(ln > 0.0, rc, torch.full_like(rc, -1.0))


CULL_COORD_MAX = 2048   # 11-bit packed mean coords; the corner cull is
                        # off (the rect shrink stays) for larger images


def _pack_cull(mx, my, rc):
    """The corner-cull data in one int32, so its broadcast is one channel:
    11 bits round(mx) | 11 bits round(my) | 9 bits ceil(rc/2) (2-px units).
    A mean outside [0, 2048) or rc < 0 turns the cull off for that
    Gaussian (max radius)."""
    mxq = torch.round(mx).to(I32)
    myq = torch.round(my).to(I32)
    inb = ((mxq >= 0) & (mxq < CULL_COORD_MAX)
           & (myq >= 0) & (myq < CULL_COORD_MAX) & (rc >= 0.0))
    rcq = torch.where(inb, torch.clamp(torch.ceil(rc * 0.5), max=511).to(I32),
                      torch.full_like(mxq, 511))
    mxq = torch.clamp(mxq, 0, CULL_COORD_MAX - 1)
    myq = torch.clamp(myq, 0, CULL_COORD_MAX - 1)
    return mxq | (myq << 11) | (rcq << 22)


def _corner_cull_keep(e_tx, e_ty, packed2, tile_w: int, tile_h: int):
    """Does the cull circle reach tile (e_tx, e_ty) at all? The +2 radius
    slack covers the 2-px rc quantization and the half-pixel mean rounding."""
    mxq = packed2 & 0x7FF
    myq = (packed2 >> 11) & 0x7FF
    rct = ((packed2 >> 22) & 0x1FF) * 2 + 2
    txlo = e_tx * tile_w
    tylo = e_ty * tile_h
    dx = mxq - torch.minimum(torch.maximum(mxq, txlo), txlo + (tile_w - 1))
    dy = myq - torch.minimum(torch.maximum(myq, tylo), tylo + (tile_h - 1))
    return dx * dx + dy * dy <= rct * rct


def _sorted_attrs(order, means2d, radii, opacities):
    """Gaussian attributes in depth order, and the opacity-aware radii."""
    mx, my = means2d[order, 0], means2d[order, 1]
    rad = radii[order]
    if opacities is None:
        return mx, my, rad, None, None
    rc_full = cull_radius(rad, opacities[order])
    rect_r = torch.where(rc_full < 0, rc_full,
                         torch.minimum(rc_full, rad.to(torch.float32)))
    return mx, my, rad, rc_full, rect_r


def _cull_on(opacities, tile_w, tile_h, tiles_x, tiles_y) -> bool:
    return (opacities is not None
            and tiles_x * tile_w <= CULL_COORD_MAX
            and tiles_y * tile_h <= CULL_COORD_MAX)


def _unpack_entries(e, startb, packedb):
    """Per entry: tile (tx, ty) from its Gaussian's packed rect origin and
    width and its position within the Gaussian's segment."""
    x0b = packedb & 0x3FF
    y0b = (packedb >> 10) & 0x3FF
    sxb = torch.clamp(packedb >> 20, min=1)
    within = e - startb
    dy = torch.div(within, sxb, rounding_mode="floor")
    dx = within - dy * sxb
    return x0b + dx, y0b + dy


def _exact(capacity: int, total: torch.Tensor) -> int:
    """``capacity``, or with 0 the count ``total`` read to the host (at
    least 1)."""
    return capacity if capacity > 0 else max(int(total), 1)


def _sentinel_tail(ids, sorted_keys, n_keys: int, m: int):
    """``ids`` (a tensor of its own) with the sentinel ``m``, in place, on
    every entry whose sorted key is past the last slot (``n_keys``): the
    tail that no span reaches."""
    return ids.masked_fill_(sorted_keys >= n_keys, m)


def _searchsorted(sorted_keys, n: int):
    return torch.searchsorted(sorted_keys, _arange(n, sorted_keys.device),
                              side="left", out_int32=True)


def isect_tiles(means2d, radii, depths, tile_w: int, tile_h: int,
                tiles_x: int, tiles_y: int, capacity: int,
                opacities=None) -> TileIntersections:
    """One camera's per-tile entry lists in a flat entry axis."""
    dev = depths.device
    num_tiles = tiles_x * tiles_y

    # 1. depth order, 2. tile rects (opacity-tightened when enabled)
    order = torch.sort(depths, stable=True).indices
    mx, my, rad, rc_full, rect_r = _sorted_attrs(order, means2d, radii, opacities)
    x0, y0, spanx, spany = gaussian_tile_rect(
        torch.stack([mx, my], -1), rad, tile_w, tile_h, tiles_x, tiles_y, rect_r)
    counts = spanx * spany
    cum = cumsum_i32(counts)
    total = cum[-1]
    capacity = _exact(capacity, total)

    # 3. expand: entry e belongs to depth rank g with cum[g-1] <= e < cum[g]
    e = _arange(capacity, dev)
    seg_starts = cum - counts
    packed = x0 | (y0 << 10) | (spanx << 20)
    cull_on = _cull_on(opacities, tile_w, tile_h, tiles_x, tiles_y)
    chans = [seg_starts, packed, order.to(I32)]
    if cull_on:
        chans.append(_pack_cull(mx, my, rc_full))
    bcast = _segment_broadcast_multi(chans, seg_starts, capacity)
    startb, packedb, gid = bcast[:3]
    tx, ty = _unpack_entries(e, startb, packedb)
    valid = e < total
    if cull_on:
        valid = valid & _corner_cull_keep(tx, ty, bcast[3], tile_w, tile_h)
    tile = torch.where(valid, ty * tiles_x + tx,
                       torch.full_like(tx, num_tiles))

    # 4. stable sort by tile id, 5. per-tile offsets
    tile_sorted, perm = torch.sort(tile, stable=True)
    tile_offsets = _searchsorted(tile_sorted, num_tiles + 1)
    return TileIntersections(
        gauss_ids=_sentinel_tail(gid[perm], tile_sorted, num_tiles,
                                 depths.shape[0]),
        tile_offsets=tile_offsets,
        num_isects=total,
        num_kept=tile_offsets[num_tiles],
    )


def isect_tile_rows(means2d, radii, depths, cam_ids, row_lo, row_hi,
                    tile_w: int, tile_h: int, tiles_x: int, tiles_y: int,
                    n_row_slots: int, capacity: int,
                    opacities=None) -> TileIntersections:
    """Per-tile entry lists of an owned span of global tile rows.

    The distributed path's tile lists: the global row axis flattens
    (camera, tile row) as ``cam * tiles_y + ty``, a device owns the rows
    [row_lo, row_hi) (ints or 0-d tensors) and lists entries for its local
    slots ``(global_row - row_lo) * tiles_x + tx``, at most
    ``n_row_slots`` rows of them. The entries (M of them) come from any
    mix of cameras, ``cam_ids`` naming each one's. The expansion is
    :func:`isect_tiles`'s, with one more broadcast channel (the camera)."""
    dev = depths.device
    num_slots = n_row_slots * tiles_x

    order = torch.sort(depths, stable=True).indices
    mx, my, rad, rc_full, rect_r = _sorted_attrs(order, means2d, radii,
                                                 opacities)
    cam = cam_ids[order].to(I32)
    x0, y0, spanx, spany = gaussian_tile_rect(
        torch.stack([mx, my], -1), rad, tile_w, tile_h, tiles_x, tiles_y,
        rect_r)
    # clip each entry's rows to the owned span of its camera and to the
    # row-slot buffer
    first = row_lo - cam * tiles_y
    ty_lo = torch.maximum(y0, first)
    ty_hi = torch.minimum(torch.minimum(y0 + spany, row_hi - cam * tiles_y),
                          first + n_row_slots)
    counts = spanx * torch.clamp(ty_hi - ty_lo, min=0)
    cum = cumsum_i32(counts)
    total = cum[-1]
    capacity = _exact(capacity, total)

    e = _arange(capacity, dev)
    seg_starts = cum - counts
    packed = x0 | (ty_lo << 10) | (spanx << 20)
    cull_on = _cull_on(opacities, tile_w, tile_h, tiles_x, tiles_y)
    chans = [seg_starts, packed, order.to(I32), cam]
    if cull_on:
        chans.append(_pack_cull(mx, my, rc_full))
    bcast = _segment_broadcast_multi(chans, seg_starts, capacity)
    startb, packedb, gid, camb = bcast[:4]
    tx, ty = _unpack_entries(e, startb, packedb)
    slot = (camb * tiles_y + ty - row_lo) * tiles_x + tx
    valid = (e < total) & (slot >= 0) & (slot < num_slots)
    if cull_on:
        valid = valid & _corner_cull_keep(tx, ty, bcast[4], tile_w, tile_h)
    slot = torch.where(valid, slot, torch.full_like(slot, num_slots)).to(I32)

    slot_sorted, perm = torch.sort(slot, stable=True)
    tile_offsets = _searchsorted(slot_sorted, num_slots + 1)
    return TileIntersections(
        gauss_ids=_sentinel_tail(gid[perm], slot_sorted, num_slots,
                                 depths.shape[0]),
        tile_offsets=tile_offsets,
        num_isects=total,
        num_kept=tile_offsets[num_slots],
    )


def isect_tile_rows_blocked(means2d, radii, depths, n_cams: int,
                            tile_w: int, tile_h: int, tiles_x: int,
                            tiles_y: int, capacity: int,
                            opacities=None) -> BlockedTileIntersections:
    """Whole-batch entry lists with a fixed per-camera entry block.

    The (B*N) universe is camera-major (camera c owns indices
    [c*N, (c+1)*N)); ``capacity`` is the total, a multiple of ``n_cams``,
    and camera c's block is [c*block, (c+1)*block) with block =
    capacity // n_cams. Each camera keeps its own overflow budget: entries
    past its block are dropped farthest first.
    """
    m = means2d.shape[0]
    if m % n_cams or capacity % n_cams:
        raise ValueError("universe and capacity must divide by n_cams")
    dev = depths.device
    n_univ = m // n_cams
    numt = tiles_x * tiles_y
    num_slots = n_cams * numt
    kspace = n_cams * (numt + 1)     # per-camera slots + 1 sentinel key
    cams = _arange(n_cams, dev)

    # 1. depth order within each camera's contiguous block
    order = (torch.sort(depths.reshape(n_cams, n_univ), dim=1,
                        stable=True).indices.to(I32)
             + (cams * n_univ)[:, None]).reshape(-1)
    mx, my, rad, rc_full, rect_r = _sorted_attrs(order, means2d, radii, opacities)

    # 2. tile rects + per-camera entry positions
    x0, y0, spanx, spany = gaussian_tile_rect(
        torch.stack([mx, my], -1), rad, tile_w, tile_h, tiles_x, tiles_y, rect_r)
    counts = spanx * spany
    cum = cumsum_i32(counts)
    cam_of_g = _arange(m, dev) // n_univ
    cam_ends = cum[(cams + 1) * n_univ - 1]
    base = torch.cat([cam_ends.new_zeros(1), cam_ends[:-1]])
    cam_tot = cam_ends - base                 # (B,) true per-camera demand
    block = _exact(capacity // n_cams, torch.max(cam_tot))
    capacity = n_cams * block
    starts_blocked = (cum - counts) - torch.repeat_interleave(base, n_univ) \
        + cam_of_g * block
    # scatter positions clamp into the NEXT block start: an overflowed
    # Gaussian's delta telescopes there with the next camera's first delta
    starts_eff = torch.minimum(starts_blocked, (cam_of_g + 1) * block)

    e = _arange(capacity, dev)
    packed = x0 | (y0 << 10) | (spanx << 20)
    cull_on = _cull_on(opacities, tile_w, tile_h, tiles_x, tiles_y)
    chans = [starts_blocked, packed, order]
    if cull_on:
        chans.append(_pack_cull(mx, my, rc_full))
    bcast = _segment_broadcast_multi(chans, starts_eff, capacity)
    startb, packedb, gid = bcast[:3]
    tx, ty = _unpack_entries(e, startb, packedb)

    # valid iff inside this camera's (capped) entry count: a block's tail
    # and any spill of a truncated Gaussian take the camera's sentinel key
    cam_e = e // block
    valid_end = cam_e * block + torch.repeat_interleave(
        torch.clamp(cam_tot, max=block), block)
    valid = e < valid_end
    if cull_on:
        valid = valid & _corner_cull_keep(tx, ty, bcast[3], tile_w, tile_h)
    key_base = cam_e * (numt + 1)
    ekey = torch.where(valid, key_base + ty * tiles_x + tx, key_base + numt)
    gid_val = torch.where(valid, gid, torch.full_like(gid, m))

    # 3. stable sort by extended key: every block keeps exactly `block`
    # entries inside its key range, so blocks stay at fixed offsets
    ekey_sorted, perm = torch.sort(ekey, stable=True)
    offs_ext = _searchsorted(ekey_sorted, kspace + 1)
    s = _arange(num_slots, dev)
    key_s = (s + s // numt).long()            # skip each camera's sentinel
    # camera c's surviving entries are the prefix [c*block, first sentinel)
    kept_c = offs_ext[((cams + 1) * (numt + 1) - 1).long()] - cams * block
    return BlockedTileIntersections(
        gauss_ids=gid_val[perm],
        tile_lo=offs_ext[key_s],
        tile_hi=offs_ext[key_s + 1],
        num_isects=n_cams * torch.max(cam_tot),
        num_kept=n_cams * torch.max(kept_c),
    )
