"""Tile blend on the card: forward (kernel K1) and backward (kernel K2).

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
    CUDA tensor it launches ``csrc/rasterize_bwd.cu``; on a CPU tensor it
    takes the plain version, ``rasterize_torch.rasterize_slots_bwd``.

Neither falls back: a CUDA tensor gets the kernel or an error.
"""

from __future__ import annotations

import torch

from .. import kernels
from .rasterize_torch import rasterize_slots, rasterize_slots_bwd, tile_spans

MAX_PIXELS = 1024     # pixels of a slot the blend kernels take
# csrc/rasterize_bwd.cu: the backward's warps each walk a patch of 32 lanes
# (so a slot's pixel count must be a multiple of 32), and add each
# Gaussian's 9 sums into a 12-float row (48 bytes: two 16-byte atomics and
# one scalar)
BWD_WARP = 32
BWD_ROW = 12


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
    d_all = torch.zeros(m, BWD_ROW, dtype=torch.float32, device=dev)
    lib = kernels.load("rasterize_bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.check(lib.gts_rasterize_bwd(
            *[x.data_ptr() for x in f32], i32[0].data_ptr(),
            i32[0].shape[0], m, *[x.data_ptr() for x in i32[1:]],
            t_slots, tile_w, tile_h, max_per_tile,
            *[x.data_ptr() for x in per_pixel], d_all.data_ptr(), stream),
            "backward blend kernel")
    rasterize_slots_vjp.launches += 1
    return split_grads(d_all)


def split_grads(d_all):
    """(d_means2d (M, 2), d_conics (M, 3), d_colors (M, 3), d_opacities
    (M,)) from the kernel's (M, 12) rows: columns 0-8, 9-11 padding."""
    return d_all[:, 0:2], d_all[:, 2:5], d_all[:, 5:8], d_all[:, 8]


class _Blend(torch.autograd.Function):
    """The blend with its backward: K1 then K2 on the card, the plain walk
    and its written-out VJP on the CPU."""

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


rasterize_slots_fwd.launches = 0
rasterize_slots_vjp.launches = 0
