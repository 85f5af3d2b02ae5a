"""Tile blend on the card: forward (kernel K1) and backward (kernels K2
and K2s).

Counterpart of grendel_tpu/ops/rasterize_pallas.py ``rasterize_slots_pl:667``
(kernels ``_fwd_kernel:181`` and ``_bwd_kernel:262`` with the segment-sum
of ``_core_bwd``), with the same arguments and the contract of
:func:`..ops.rasterize_torch.rasterize_slots`.

  * :func:`rasterize_slots_fwd` blends. On a CUDA tensor it launches
    ``csrc/rasterize_fwd.cu``; on a CPU tensor it takes the plain version,
    ``rasterize_torch.rasterize_slots``, which uses the same stop rule.
    When an input requires grad the call goes through an autograd Function
    whose backward is :func:`rasterize_slots_vjp`.
  * :func:`rasterize_slots_vjp` is the blend's vector-Jacobian product. On a
    CUDA tensor it sorts the entry ids (``torch.sort``, stable), launches
    ``csrc/rasterize_bwd.cu`` (K2), which stores one row of 9 gradients per
    entry, and sums the rows per Gaussian in entry order with
    :func:`segment_sum` (K2s, ``csrc/segment_sum.cu``). No float atomic is
    left, so like inputs give like bits on every run. On a CPU tensor it
    takes the plain version, ``rasterize_torch.rasterize_slots_bwd``.
  * :func:`segment_sum` is K2s alone; on a CPU tensor its plain version,
    ``rasterize_torch.segment_sum_rows``.

None falls back: a CUDA tensor gets the kernel or an error.
"""

from __future__ import annotations

import torch

from .. import kernels
from .rasterize_torch import (rasterize_slots, rasterize_slots_bwd,
                              rasterize_slots_bwd_rows, segment_sum_rows,
                              tile_spans)

MAX_PIXELS = 1024     # pixels of a slot the blend kernels take
# csrc/rasterize_bwd.cu: the backward's warps each walk a patch of 32 lanes
# (so a slot's pixel count must be a multiple of 32), and store each
# entry's 9 sums as a 9-float row (36 bytes); csrc/segment_sum.cu sums them
# into one 9-float row per Gaussian
BWD_WARP = 32
BWD_ROW = 9


def _check_inputs(means2d, conics, colors, opacities, gauss_ids, lo, hi,
                  slot_px0, slot_py0, tile_w, tile_h):
    """Contiguous f32 splats and i32 index arrays for a kernel launch;
    ``means2d`` 8-byte aligned (K1 copies a mean in one 8-byte piece)."""
    p = tile_w * tile_h
    if not 1 <= p <= MAX_PIXELS:
        raise ValueError(f"tile of {p} pixels: the kernel takes 1..{MAX_PIXELS}")
    dev = means2d.device
    if dev.type != "cuda":
        raise ValueError(f"no blend kernel for device {dev}")
    t_slots = lo.shape[0]
    m = means2d.shape[0]
    f32 = [x.to(torch.float32).contiguous()
           for x in (means2d, conics, colors, opacities)]
    if f32[0].data_ptr() % 8:
        f32[0] = f32[0].clone()
    i32 = [x.to(torch.int32).contiguous()
           for x in (gauss_ids, lo, hi, slot_px0, slot_py0)]
    for x in f32 + i32:
        if x.device != dev:
            raise ValueError("all blend inputs must be on one device")
    if (f32[0].shape != (m, 2) or f32[1].shape != (m, 3)
            or f32[2].shape != (m, 3) or f32[3].shape != (m,)):
        raise ValueError("means2d/conics/colors/opacities must be "
                         "(M,2)/(M,3)/(M,3)/(M,)")
    if any(x.shape != (t_slots,) for x in i32[1:]):
        raise ValueError("tile spans and slot origins must be (T,)")
    return f32, i32


def _blend(means2d, conics, colors, opacities, gauss_ids, lo, hi,
           slot_px0, slot_py0, tile_w, tile_h, max_per_tile):
    if means2d.device.type == "cpu":
        return rasterize_slots(
            means2d, conics, colors, opacities, gauss_ids, None, slot_px0,
            slot_py0, tile_w, tile_h, max_per_tile, tile_lo=lo, tile_hi=hi)
    f32, i32 = _check_inputs(means2d, conics, colors, opacities, gauss_ids,
                             lo, hi, slot_px0, slot_py0, tile_w, tile_h)
    dev, t_slots, m = means2d.device, lo.shape[0], means2d.shape[0]
    p = tile_w * tile_h
    out_c = torch.empty(t_slots, p, 3, dtype=torch.float32, device=dev)
    out_t = torch.empty(t_slots, p, dtype=torch.float32, device=dev)
    lib = kernels.load("rasterize_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.check(lib.gts_rasterize_fwd(
            *[x.data_ptr() for x in f32], i32[0].data_ptr(),
            i32[0].shape[0], m, *[x.data_ptr() for x in i32[1:]],
            t_slots, tile_w, tile_h, max_per_tile,
            out_c.data_ptr(), out_t.data_ptr(), stream), "blend kernel")
    rasterize_slots_fwd.launches += 1
    return out_c, out_t


def _blend_vjp(means2d, conics, colors, opacities, gauss_ids, lo, hi,
               slot_px0, slot_py0, tile_w, tile_h, max_per_tile,
               c_total, final_t, g, g_t):
    if means2d.device.type == "cpu":
        return rasterize_slots_bwd(
            means2d, conics, colors, opacities, gauss_ids, None, slot_px0,
            slot_py0, tile_w, tile_h, max_per_tile, tile_lo=lo, tile_hi=hi,
            c_total=c_total, final_t=final_t, g=g, g_t=g_t)
    ids = gauss_ids.to(torch.int32).contiguous()
    # the entries by Gaussian for K2s, sorted before K2's rows exist so
    # that the sort's buffers and the rows are not live at once
    order = torch.sort(ids, stable=True)
    rows = _vjp_rows(means2d, conics, colors, opacities, ids, lo, hi,
                     slot_px0, slot_py0, tile_w, tile_h, max_per_tile,
                     c_total, final_t, g, g_t)
    return split_grads(segment_sum(rows, means2d.shape[0], order))


def _vjp_rows(means2d, conics, colors, opacities, gauss_ids, lo, hi,
              slot_px0, slot_py0, tile_w, tile_h, max_per_tile,
              c_total, final_t, g, g_t):
    """K2 on the card: each entry's row, (E, 9)."""
    if (tile_w * tile_h) % BWD_WARP:
        raise ValueError(f"tile {tile_w}x{tile_h}: the backward kernel takes "
                         f"a multiple of {BWD_WARP} pixels")
    f32, i32 = _check_inputs(means2d, conics, colors, opacities, gauss_ids,
                             lo, hi, slot_px0, slot_py0, tile_w, tile_h)
    dev, t_slots, m = means2d.device, lo.shape[0], means2d.shape[0]
    p = tile_w * tile_h
    per_pixel = [x.to(torch.float32).contiguous()
                 for x in (c_total, final_t, g, g_t)]
    for x, shape in zip(per_pixel, ((t_slots, p, 3), (t_slots, p),
                                    (t_slots, p, 3), (t_slots, p))):
        if x.shape != shape or x.device != dev:
            raise ValueError(f"forward outputs and cotangents must be "
                             f"{shape} on {dev}, got {tuple(x.shape)}")
    ids = i32[0]
    rows = torch.empty(ids.shape[0], BWD_ROW, dtype=torch.float32,
                       device=dev)
    lib = kernels.load("rasterize_bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.check(lib.gts_rasterize_bwd(
            *[x.data_ptr() for x in f32], ids.data_ptr(), ids.shape[0], m,
            *[x.data_ptr() for x in i32[1:]], t_slots, tile_w, tile_h,
            max_per_tile, *[x.data_ptr() for x in per_pixel],
            rows.data_ptr(), stream), "backward blend kernel")
    rasterize_slots_vjp.launches += 1
    return rows


def segment_sum(rows, m: int, order):
    """(M, 9): row g is the sum of the rows of ``rows`` (E, 9) whose ids
    equal g, in ascending entry order; ids outside [0, M) are dropped.
    ``order`` is ``torch.sort(ids, stable=True)`` of the entries' int32
    ids (E,): its sorted values and int64 indices. On a CUDA tensor it
    launches kernel K2s (``csrc/segment_sum.cu``); on a CPU tensor it
    takes the plain version, ``rasterize_torch.segment_sum_rows``, on the
    rows in sorted order, which adds each Gaussian's rows in the same
    order. Both give the same bits."""
    sorted_ids, perm = order
    n = perm.shape[0]
    if rows.device.type == "cpu":
        return segment_sum_rows(rows[perm], sorted_ids, m)
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"no segment-sum kernel for device {dev}")
    if (rows.dtype != torch.float32 or not rows.is_contiguous()
            or rows.shape != (n, BWD_ROW)):
        raise ValueError(f"rows must be contiguous f32 ({n}, {BWD_ROW}) on "
                         f"{dev}, got {rows.dtype} {tuple(rows.shape)}")
    if (sorted_ids.dtype != torch.int32 or perm.dtype != torch.int64
            or sorted_ids.shape != (n,) or sorted_ids.device != dev
            or perm.device != dev):
        raise ValueError("order must be int32 sorted ids and int64 "
                         f"indices of length {n} on {dev}")
    out = torch.empty(m, BWD_ROW, dtype=torch.float32, device=dev)
    lib = kernels.load("segment_sum")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.check(lib.gts_segment_sum_rows(
            rows.data_ptr(), sorted_ids.data_ptr(), perm.data_ptr(), n, m,
            out.data_ptr(), stream), "segment-sum kernel")
    segment_sum.launches += 1
    return out


def split_grads(d_all):
    """(d_means2d (M, 2), d_conics (M, 3), d_colors (M, 3), d_opacities
    (M,)) from the (M, 9) rows K2s writes: columns 0-1, 2-4, 5-7 and 8."""
    return d_all[:, 0:2], d_all[:, 2:5], d_all[:, 5:8], d_all[:, 8]


class _Blend(torch.autograd.Function):
    """The blend with its backward: K1 then K2 and K2s on the card, the
    plain walk and its written-out VJP on the CPU."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, gauss_ids, lo, hi,
                slot_px0, slot_py0, tile_w, tile_h, max_per_tile):
        c_total, final_t = _blend(means2d, conics, colors, opacities,
                                  gauss_ids, lo, hi, slot_px0, slot_py0,
                                  tile_w, tile_h, max_per_tile)
        ctx.save_for_backward(means2d, conics, colors, opacities, gauss_ids,
                              lo, hi, slot_px0, slot_py0, c_total, final_t)
        ctx.geometry = (tile_w, tile_h, max_per_tile)
        return c_total, final_t

    @staticmethod
    def backward(ctx, g, g_t):
        *fwd_in, c_total, final_t = ctx.saved_tensors
        grads = _blend_vjp(*fwd_in, *ctx.geometry, c_total, final_t, g, g_t)
        return (*grads,) + (None,) * 8


def rasterize_slots_fwd(
    means2d, conics, colors, opacities, gauss_ids, tile_offsets=None,
    slot_px0=None, slot_py0=None, tile_w: int = 16, tile_h: int = 16,
    max_per_tile: int = 1024, *, tile_lo=None, tile_hi=None,
):
    """Blend every tile slot: (colors (T, P, 3), final_t (T, P)).

    Spans come from flat ``tile_offsets`` ((T+1,)) or from blocked
    ``tile_lo``/``tile_hi`` ((T,) each). Differentiable in ``means2d``,
    ``conics``, ``colors`` and ``opacities``."""
    lo, hi = tile_spans(tile_offsets, tile_lo, tile_hi)
    args = (means2d, conics, colors, opacities, gauss_ids, lo, hi,
            slot_px0, slot_py0, tile_w, tile_h, max_per_tile)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (means2d, conics, colors, opacities)):
        return _Blend.apply(*args)
    return _blend(*args)


def rasterize_slots_vjp(
    means2d, conics, colors, opacities, gauss_ids, tile_offsets=None,
    slot_px0=None, slot_py0=None, tile_w: int = 16, tile_h: int = 16,
    max_per_tile: int = 1024, *, tile_lo=None, tile_hi=None,
    c_total, final_t, g, g_t,
):
    """The blend's VJP: (d_means2d (M, 2), d_conics (M, 3), d_colors (M, 3),
    d_opacities (M,)) from the forward's outputs ``c_total`` (T, P, 3) and
    ``final_t`` (T, P) and their cotangents ``g`` and ``g_t``. The contract
    of ``rasterize_torch.rasterize_slots_bwd``."""
    lo, hi = tile_spans(tile_offsets, tile_lo, tile_hi)
    return _blend_vjp(means2d, conics, colors, opacities, gauss_ids, lo, hi,
                      slot_px0, slot_py0, tile_w, tile_h, max_per_tile,
                      c_total, final_t, g, g_t)


def rasterize_slots_vjp_rows(
    means2d, conics, colors, opacities, gauss_ids, tile_offsets=None,
    slot_px0=None, slot_py0=None, tile_w: int = 16, tile_h: int = 16,
    max_per_tile: int = 1024, *, tile_lo=None, tile_hi=None,
    c_total, final_t, g, g_t,
):
    """K2 alone: each entry's row of 9 gradients, (E, 9), the rows that
    :func:`rasterize_slots_vjp` sums per Gaussian with K2s. On a CPU
    tensor the plain version, ``rasterize_torch.rasterize_slots_bwd_rows``.
    The arguments are :func:`rasterize_slots_vjp`'s."""
    if means2d.device.type == "cpu":
        return rasterize_slots_bwd_rows(
            means2d, conics, colors, opacities, gauss_ids, tile_offsets,
            slot_px0, slot_py0, tile_w, tile_h, max_per_tile,
            tile_lo=tile_lo, tile_hi=tile_hi, c_total=c_total,
            final_t=final_t, g=g, g_t=g_t)
    lo, hi = tile_spans(tile_offsets, tile_lo, tile_hi)
    return _vjp_rows(means2d, conics, colors, opacities, gauss_ids, lo, hi,
                     slot_px0, slot_py0, tile_w, tile_h, max_per_tile,
                     c_total, final_t, g, g_t)


rasterize_slots_fwd.launches = 0
rasterize_slots_vjp.launches = 0
segment_sum.launches = 0
