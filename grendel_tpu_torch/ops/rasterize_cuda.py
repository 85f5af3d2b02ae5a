"""Forward tile blend on the card (kernel K1).

Counterpart of grendel_tpu/ops/rasterize_pallas.py ``rasterize_slots_pl:667``
(kernel ``_fwd_kernel:181``), with the same arguments and the contract of
:func:`..ops.rasterize_torch.rasterize_slots`. On a CUDA tensor
:func:`rasterize_slots_fwd` launches the hand-written kernel in
``csrc/rasterize_fwd.cu``; on a CPU tensor it takes the plain version,
``rasterize_torch.rasterize_slots``, which uses the same stop rule.

Only the forward is ported. When an input requires grad the call goes
through an autograd Function whose backward raises, so a training caller
fails loudly instead of getting wrong gradients.
"""

from __future__ import annotations

import torch

from .. import kernels
from .rasterize_torch import rasterize_slots, tile_spans

MAX_PIXELS = 1024     # one thread per pixel of a slot


def _blend(means2d, conics, colors, opacities, gauss_ids, lo, hi,
           slot_px0, slot_py0, tile_w, tile_h, max_per_tile):
    dev = means2d.device
    if dev.type == "cpu":
        return rasterize_slots(
            means2d, conics, colors, opacities, gauss_ids, None, slot_px0,
            slot_py0, tile_w, tile_h, max_per_tile, tile_lo=lo, tile_hi=hi)
    if dev.type != "cuda":
        raise ValueError(f"no blend kernel for device {dev}")
    p = tile_w * tile_h
    if not 1 <= p <= MAX_PIXELS:
        raise ValueError(f"tile of {p} pixels: the kernel takes 1..{MAX_PIXELS}")
    t_slots = lo.shape[0]
    m = means2d.shape[0]
    f32 = [x.to(torch.float32).contiguous()
           for x in (means2d, conics, colors, opacities)]
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


class _ForwardOnly(torch.autograd.Function):
    """The forward blend for inputs that require grad; no backward yet."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, *rest):
        return _blend(means2d, conics, colors, opacities, *rest)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("backward blend: training slice")


def rasterize_slots_fwd(
    means2d, conics, colors, opacities, gauss_ids, tile_offsets=None,
    slot_px0=None, slot_py0=None, tile_w: int = 16, tile_h: int = 16,
    max_per_tile: int = 1024, *, tile_lo=None, tile_hi=None,
):
    """Blend every tile slot: (colors (T, P, 3), final_t (T, P)).

    Spans come from flat ``tile_offsets`` ((T+1,)) or from blocked
    ``tile_lo``/``tile_hi`` ((T,) each)."""
    lo, hi = tile_spans(tile_offsets, tile_lo, tile_hi)
    args = (means2d, conics, colors, opacities, gauss_ids, lo, hi,
            slot_px0, slot_py0, tile_w, tile_h, max_per_tile)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (means2d, conics, colors, opacities)):
        return _ForwardOnly.apply(*args)
    return _blend(*args)


rasterize_slots_fwd.launches = 0
