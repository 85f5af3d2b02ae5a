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
``csrc/resize.cu``; on a CPU tensor it takes the plain version,
:func:`resize_bilinear_plain`, the same integer arithmetic in int64
PyTorch. Both give PIL's bytes.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import kernels

PRECISION_BITS = 22        # Pillow's 32 - 8 - 2


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
    launches the kernel of ``csrc/resize.cu`` (its two passes in one call
    of its C entry point); on a CPU tensor it takes
    :func:`resize_bilinear_plain`."""
    _check(img, size)
    if img.device.type == "cpu":
        return resize_bilinear_plain(img, size)
    dev = img.device
    if dev.type != "cuda":
        raise ValueError(f"no resize kernel for device {dev}")
    (w, h), (in_h, in_w, c) = size, img.shape
    img = img.contiguous()
    tables, xks, yks = _device_tables(in_w, w, in_h, h, dev)
    tmp = torch.empty((in_h, w, c), dtype=torch.uint8, device=dev)
    out = torch.empty((h, w, c), dtype=torch.uint8, device=dev)
    lib = kernels.load("resize")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.check(lib.gts_resize_bilinear(
            img.data_ptr(), tmp.data_ptr(), out.data_ptr(), in_h, in_w, h, w,
            c, tables[0].data_ptr(), tables[1].data_ptr(), xks,
            tables[2].data_ptr(), tables[3].data_ptr(), yks, stream),
            "resize kernel")
    resize_bilinear.launches += 1
    return out


resize_bilinear.launches = 0
