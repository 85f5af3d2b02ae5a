"""Inclusive int32 prefix scan over C equal-length channels (kernel K3).

Counterpart of grendel_tpu/ops/scan_pallas.py (``_cumsum_kernel:65``,
``cumsum_i32_multi:79``, ``cumsum_i32:118``). The tile-list build
(ops/isect.py) scans its per-Gaussian entry counts and the scatter-delta
buffers of its segment broadcasts with it.

On a CUDA tensor :func:`cumsum_i32_multi` launches the hand-written kernel
in ``csrc/scan.cu``; on a CPU tensor it takes the plain version,
:func:`cumsum_i32_multi_plain`. Results are bit-equal to
``torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)``: int32 adds wrap
and are associative.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

MAX_CHANNELS = 8      # csrc/scan.cu kMaxChannels


def cumsum_i32_multi_plain(xs) -> list:
    """Plain version: one ``torch.cumsum`` per channel."""
    return [torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32) for x in xs]


def cumsum_i32_multi(xs) -> list:
    """Inclusive cumsum of each 1-D array in ``xs`` (same length, same
    device), as int32."""
    xs = [x.to(torch.int32).contiguous() for x in xs]
    if not xs or len(xs) > MAX_CHANNELS:
        raise ValueError(f"need 1..{MAX_CHANNELS} channels, got {len(xs)}")
    m = xs[0].shape[0]
    dev = xs[0].device
    for x in xs:
        if x.dim() != 1 or x.shape[0] != m or x.device != dev:
            raise ValueError("channels must be 1-D, equal length, one device")
    if dev.type == "cpu":
        return cumsum_i32_multi_plain(xs)
    if dev.type != "cuda":
        raise ValueError(f"no scan kernel for device {dev}")
    lib = kernels.load("scan")
    outs = [torch.empty_like(x) for x in xs]
    tile = lib.gts_scan_tile_elems()
    n_tiles = max(-(-m // tile), 1)
    scratch = torch.empty(len(xs) * n_tiles, dtype=torch.int32, device=dev)
    ins = (ctypes.c_void_p * len(xs))(*[x.data_ptr() for x in xs])
    outp = (ctypes.c_void_p * len(xs))(*[o.data_ptr() for o in outs])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.check(lib.gts_scan_i32(ins, outp, len(xs), m,
                                       scratch.data_ptr(), stream),
                      "scan kernel")
    cumsum_i32_multi.launches += 1
    return outs


cumsum_i32_multi.launches = 0


def cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """Single-channel form of :func:`cumsum_i32_multi`."""
    return cumsum_i32_multi([x])[0]
