"""PIL's bilinear resize (``Image.resize(size, Image.BILINEAR)``) of
uint8 images, bit for bit.

The JAX package resizes its ground truth with PIL at decode
(grendel_tpu/data/scene.py decode_image, :63) under ``--resolution``; the
port does it on the scene's device. Pillow's ``ImagingResample``
(Resample.c) is a separable pass of a triangle filter, first along the
rows and then along the columns, in fixed point:

  * the coefficients of each output position come from a double-precision
    triangle of support ``max(in / out, 1)``, normalized to sum 1, then
    each rounded by ``(int)(+-0.5 + k * 2**22)`` (:func:`coefficients`,
    on the host, as Pillow computes them);
  * each output byte is ``clip((2**21 + sum(pixel * k)) >> 22)`` in 32-bit
    integers, and the horizontal pass's bytes feed the vertical pass;
  * RGBA is resized premultiplied by alpha (``c * a + 128``, then ``(t +
    (t >> 8)) >> 8``) and divided again after (``255 * c // a``, clipped,
    where alpha is neither 0 nor 255), as Pillow's ``resize`` does through
    mode "RGBa".

:func:`resize_bilinear` takes (H, W, C) uint8, C = 1, 3 or 4 (4 is RGBA).
On a CUDA tensor it launches the hand-written kernel of
``csrc/resize.cu``, both passes in one launch over tiles of the output
that :func:`tile_plan` sizes on the host; on a CPU tensor it takes the
plain version, :func:`resize_bilinear_plain`, the same integer arithmetic
in int64 PyTorch. Both give PIL's bytes.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels

PRECISION_BITS = 22        # Pillow's 32 - 8 - 2

# the kernel's tiles (csrc/resize.cu): 256 threads a block, a power of two
# of output columns (at most 256) and any number of output rows; a
# Hopper block's dynamic shared memory, and the share that leaves four
# blocks on an SM (228 KB, less 1 KB each); at least this many blocks
# where the output allows (two waves of four blocks on 132 SMs)
THREADS = 256
TILE_WIDTHS = (128, 64, 32, 16, 8, 4, 2, 1)
TILE_HEIGHTS = (32, 16, 8, 4, 2, 1)
SMEM_MAX = 232_448
SMEM_TARGET = 57 * 1024 - 1024
MIN_BLOCKS = 2 * 4 * 132
MAX_GRID_Y = 65_535
# the tap counts the kernel unrolls (every position of both axes at most
# that many; 0 where some position has more); the bytes it may read past
# a span's last row
TAPS_UNROLLED = (3, 4, 8, 16)
IN_PAD = 80


@functools.lru_cache(maxsize=64)
def coefficients(in_size: int, out_size: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for the
    bilinear filter over the whole input: (bounds (out, 2) int32 of
    (first input index, taps), coefficients (out, ksize) int32, ksize).
    Cached, since a dataset's views share their sizes: callers copy the
    arrays and never write them."""
    scale = in_size / out_size           # (double)(in1 - in0) / outSize
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xx = np.arange(out_size, dtype=np.float64)
    center = 0.0 + (xx + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    k = np.zeros((out_size, ksize), np.float64)
    ww = np.zeros(out_size, np.float64)
    for x in range(ksize):
        t = np.abs(((x + xmin).astype(np.float64) - center + 0.5) * ss)
        w = np.where(t < 1.0, 1.0 - t, 0.0)
        w = np.where(x < xmax, w, 0.0)
        k[:, x] = w
        ww += w                          # in tap order, as Pillow sums
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None],
                 k)
    one = float(1 << PRECISION_BITS)
    kk = np.where(k < 0, np.trunc(-0.5 + k * one),
                  np.trunc(0.5 + k * one)).astype(np.int32)
    bounds = np.stack([xmin, xmax], axis=1).astype(np.int32)
    return bounds, kk, ksize


def _clip8(ss: torch.Tensor) -> torch.Tensor:
    return torch.clamp(ss >> PRECISION_BITS, 0, 255)


def _pass(img: torch.Tensor, bounds, kk, axis: int) -> torch.Tensor:
    """One resample pass of int64 ``img`` along ``axis`` (0 rows, 1
    columns), the sums in int64 (exact: Pillow's int32 sums do not
    overflow for 8-bit input)."""
    n = img.shape[axis]
    first = torch.as_tensor(bounds[:, 0], dtype=torch.int64,
                            device=img.device)
    taps = torch.as_tensor(bounds[:, 1], dtype=torch.int64,
                           device=img.device)
    k = torch.as_tensor(kk, dtype=torch.int64, device=img.device)
    out_n = k.shape[0]
    shape = [1] * img.dim()
    shape[axis] = out_n
    acc = torch.full(img.shape[:axis] + (out_n,) + img.shape[axis + 1:],
                     1 << (PRECISION_BITS - 1), dtype=torch.int64,
                     device=img.device)
    for t in range(k.shape[1]):
        idx = torch.clamp(first + t, max=n - 1)
        w = torch.where(t < taps, k[:, t], 0).reshape(shape)
        acc += torch.index_select(img, axis, idx) * w
    return _clip8(acc)


def resize_bilinear_plain(img: torch.Tensor, size) -> torch.Tensor:
    """(h, w, C) uint8 of ``img`` (H, W, C) uint8, C = 1, 3 or 4 (RGBA),
    resized to ``size`` = (w, h): PIL's bytes, in int64 PyTorch."""
    _check(img, size)
    (w, h), (in_h, in_w, c) = size, img.shape
    x = img.to(torch.int64)
    if c == 4:
        t = x[..., :3] * x[..., 3:] + 128
        x = torch.cat([((t >> 8) + t) >> 8, x[..., 3:]], dim=-1)
    xb, xk, _ = coefficients(in_w, w)
    yb, yk, _ = coefficients(in_h, h)
    out = _pass(_pass(x, xb, xk, 1), yb, yk, 0)
    if c == 4:
        a = out[..., 3:]
        div = torch.clamp((255 * out[..., :3]) // torch.clamp(a, min=1),
                          max=255)
        keep = (a == 0) | (a == 255)
        out = torch.cat([torch.where(keep, out[..., :3], div), a], dim=-1)
    return out.to(torch.uint8)


def _check(img: torch.Tensor, size) -> None:
    if (img.dtype != torch.uint8 or img.dim() != 3
            or img.shape[-1] not in (1, 3, 4)):
        raise ValueError(f"resize takes (H, W, C) uint8 with C 1, 3 or 4, "
                         f"got {img.dtype} {tuple(img.shape)}")
    w, h = size
    if w < 1 or h < 1 or img.shape[0] < 1 or img.shape[1] < 1:
        raise ValueError(f"resize of {tuple(img.shape)} to {size}")


class TilePlan(NamedTuple):
    """The kernel's tiling of one shape: ``tile_w`` x ``tile_h`` output
    pixels a block on a ``grid`` of (columns, rows) of tiles; ``rows``, the
    most input rows a tile's taps span, and ``row_bytes``, the shared
    bytes that hold the most a tile's span of a row takes in whole
    16-byte chunks at any alignment; ``taps``, the unrolled tap count of
    ``TAPS_UNROLLED`` (0: looped); ``smem``, a block's shared bytes."""

    tile_w: int
    tile_h: int
    rows: int
    row_bytes: int
    taps: int
    smem: int
    grid: tuple


def _round16(n: int) -> int:
    return (n + 15) & ~15


def tile_spans(bounds: np.ndarray, tile: int):
    """(lo, hi) int64 arrays, one entry per tile of ``tile`` consecutive
    output positions of an axis with ``bounds`` (out, 2) of (first,
    taps): the input span [lo, hi) of the tile's taps, from the first tap
    of its first position to the last tap of its last (Pillow's bounds
    rise with the position), as the kernel computes it."""
    n = bounds.shape[0]
    first = np.arange(0, n, tile)
    last = np.minimum(first + tile, n) - 1
    b = bounds.astype(np.int64)
    return b[first, 0], b[last, 0] + b[last, 1]


def smem_bytes(c: int, tile_w: int, tile_h: int, rows: int, row_bytes: int,
               xks: int, yks: int, taps: int) -> int:
    """A block's shared bytes (csrc/resize.cu ``Layout``): the input rows
    and ``IN_PAD``, reused by the output tile (rows of ``tile_w * c``
    bytes and a 4-byte group at any offset within 16), the uint8
    intermediate with ``taps`` rows to spare, and the tile's coefficient
    rows (``taps`` wide, or the whole table row where it is 0) and
    bounds."""
    mid_stride = (tile_w * c + 3) & ~3
    out_stride = _round16(tile_w * c + 18)
    ksx, ksy = taps or xks, taps or yks
    return (_round16(max(rows * row_bytes + IN_PAD, tile_h * out_stride))
            + _round16((rows + taps) * mid_stride)
            + 4 * (tile_w * ksx + tile_h * ksy + 2 * tile_w + 2 * tile_h))


def _plan(in_h, in_w, out_h, out_w, c, tile_w, tile_h) -> TilePlan:
    xb, _, xks = coefficients(in_w, out_w)
    yb, _, yks = coefficients(in_h, out_h)
    lo, hi = tile_spans(xb, tile_w)
    # a span of B bytes starts anywhere within a 16-byte chunk, so its
    # aligned chunks take at most B + 30 bytes, rounded down to 16
    row_bytes = 16 * ((int((hi - lo).max()) * c + 30) // 16)
    lo, hi = tile_spans(yb, tile_h)
    rows = int((hi - lo).max())
    most = int(max(xb[:, 1].max(), yb[:, 1].max()))
    taps = next((k for k in TAPS_UNROLLED if k >= most), 0)
    grid = (-(-out_w // tile_w), -(-out_h // tile_h))
    return TilePlan(tile_w, tile_h, rows, row_bytes, taps,
                    smem_bytes(c, tile_w, tile_h, rows, row_bytes, xks, yks,
                               taps), grid)


@functools.lru_cache(maxsize=64)
def tile_plan(in_h: int, in_w: int, out_h: int, out_w: int,
              c: int) -> TilePlan:
    """The kernel's tile for resizing (in_h, in_w, c) to (out_h, out_w).
    Of the tiles whose shared memory fits a block (and whose grid fits),
    the first by: fitting four blocks on an SM; a pixel for each of the
    block's threads; giving ``MIN_BLOCKS`` blocks, or as many as the
    output allows; the most output pixels (the fewer input rows passed
    twice by adjacent tiles); the most rows. So the tile shrinks as the
    scale grows. Raises where no tile fits, as where a few output pixels
    span thousands of input rows."""
    best, best_key = None, None
    for tw in TILE_WIDTHS:
        if tw > 1 and tw // 2 >= out_w:
            continue                       # a narrower tile holds the row
        for th in TILE_HEIGHTS:
            if (th > 1 and th // 2 >= out_h) or -(-out_h // th) > MAX_GRID_Y:
                continue
            plan = _plan(in_h, in_w, out_h, out_w, c, tw, th)
            if plan.smem > SMEM_MAX:
                continue
            key = (plan.smem <= SMEM_TARGET, min(tw * th, THREADS),
                   min(plan.grid[0] * plan.grid[1], MIN_BLOCKS), tw * th, th)
            if best_key is None or key > best_key:
                best, best_key = plan, key
    if best is None:
        raise ValueError(f"resize of ({in_h}, {in_w}, {c}) to ({out_h}, "
                         f"{out_w}): no tile's input span fits a block's "
                         f"{SMEM_MAX} bytes of shared memory")
    return best


@functools.lru_cache(maxsize=16)
def _device_tables(in_w: int, w: int, in_h: int, h: int, dev):
    """The kernel's tables on ``dev``, (x bounds, x coefficients, y
    bounds, y coefficients), and the two strides: uploaded once for each
    shape, as a dataset's views share theirs (read only)."""
    xb, xk, xks = coefficients(in_w, w)
    yb, yk, yks = coefficients(in_h, h)
    return [torch.tensor(a, device=dev) for a in (xb, xk, yb, yk)], xks, yks


def resize_bilinear(img: torch.Tensor, size) -> torch.Tensor:
    """(h, w, C) uint8 of ``img`` (H, W, C) uint8 resized to ``size`` =
    (w, h), PIL's bilinear resize bit for bit. On a CUDA tensor it
    launches the kernel of ``csrc/resize.cu`` once, on the tiles of
    :func:`tile_plan`, with no intermediate in device memory (raising
    where no tile fits); on a CPU tensor it takes
    :func:`resize_bilinear_plain`."""
    _check(img, size)
    if img.device.type == "cpu":
        return resize_bilinear_plain(img, size)
    dev = img.device
    if dev.type != "cuda":
        raise ValueError(f"no resize kernel for device {dev}")
    (w, h), (in_h, in_w, c) = size, img.shape
    plan = tile_plan(in_h, in_w, h, w, c)
    img = img.contiguous()
    tables, xks, yks = _device_tables(in_w, w, in_h, h, dev)
    out = torch.empty((h, w, c), dtype=torch.uint8, device=dev)
    lib = kernels.load("resize")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.check(lib.gts_resize_bilinear(
            img.data_ptr(), out.data_ptr(), in_h, in_w, h, w, c,
            tables[0].data_ptr(), tables[1].data_ptr(), xks,
            tables[2].data_ptr(), tables[3].data_ptr(), yks,
            plan.tile_w.bit_length() - 1, plan.tile_h, plan.rows,
            plan.row_bytes, plan.taps, stream), "resize kernel")
    resize_bilinear.launches += 1
    return out


resize_bilinear.launches = 0
