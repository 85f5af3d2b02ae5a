"""The resize kernel's tile plan (ops/resize.py ``tile_plan``), on the
CPU: the kernel (csrc/resize.cu) runs only on the card, so what it reads
is held here through the host function that plans it.

For each shape: the truck view's (1957x1091 -> 1600x891), a full-size
Mip-NeRF 360 view under the ``-r -1`` rule (5187x3361 -> 1600x1037),
tests/test_torch_image_decode.py's ``RESIZE_CASES`` in grey, RGB and
RGBA, a one-pixel output, a one-pixel input, downscales by 8 and by 20,
and widths whose rows are no multiple of 16 bytes:

  * every output tile's planned input span holds each of its taps'
    [first, first + taps) in both axes;
  * the span's rows fit the plan's ``rows`` and its columns, at each of
    the 16 offsets a row can start at within a 16-byte chunk, fit the
    plan's ``row_bytes``; the block's shared bytes fit 232,448;
  * a plain-PyTorch resize that reads each tile's planned span alone
    (``_resize_by_tiles``) equals ``resize_bilinear_plain`` bit for bit.
"""

import numpy as np
import pytest
import torch

from grendel_tpu_torch.ops import resize as R

from test_torch_image_decode import RESIZE_CASES

# ((in_w, in_h), (out_w, out_h), channels)
SHAPES = {
    "truck": ((1957, 1091), (1600, 891), 3),
    "mip360_full": ((5187, 3361), (1600, 1037), 3),
    "one_pixel_out": ((37, 23), (1, 1), 3),
    "one_pixel_in": ((1, 1), (13, 7), 4),
    "down_8": ((800, 600), (100, 75), 3),
    "down_20": ((1000, 620), (50, 31), 4),
    "rows_not_16": ((97, 61), (41, 29), 3),
    "rows_not_16_grey": ((1001, 77), (333, 50), 1),
}
for _case, (_src, _dst) in RESIZE_CASES.items():
    for _c in (1, 3, 4):
        SHAPES[f"{_case}_c{_c}"] = (_src, _dst, _c)


def _image(w, h, c, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    if c == 4:
        img[..., 3] = rng.choice([0, 255, 1, 77, 128, 254], (h, w))
    return torch.from_numpy(img)


def _resize_by_tiles(img, size, plan):
    """The resize as the kernel tiles it, in int64 PyTorch: each output
    tile from the input rows and columns of its planned span alone (a
    column strip's horizontal pass reads only the strip's span, and each
    tile of the strip only its rows of that pass)."""
    (w, h), (in_h, in_w, c) = size, img.shape
    x = img.to(torch.int64)
    if c == 4:
        t = x[..., :3] * x[..., 3:] + 128
        x = torch.cat([((t >> 8) + t) >> 8, x[..., 3:]], dim=-1)
    xb, xk, _ = R.coefficients(in_w, w)
    yb, yk, _ = R.coefficients(in_h, h)
    xlo, xhi = R.tile_spans(xb, plan.tile_w)
    ylo, yhi = R.tile_spans(yb, plan.tile_h)
    out = torch.empty((h, w, c), dtype=torch.int64)
    for tx in range(plan.grid[0]):
        cols = slice(tx * plan.tile_w, min((tx + 1) * plan.tile_w, w))
        strip = x[:, xlo[tx]:xhi[tx]]
        mid = R._pass(strip, xb[cols] - [xlo[tx], 0], xk[cols], 1)
        for ty in range(plan.grid[1]):
            rows = slice(ty * plan.tile_h, min((ty + 1) * plan.tile_h, h))
            out[rows, cols] = R._pass(mid[ylo[ty]:yhi[ty]],
                                      yb[rows] - [ylo[ty], 0], yk[rows], 0)
    if c == 4:
        a = out[..., 3:]
        div = torch.clamp((255 * out[..., :3]) // torch.clamp(a, min=1),
                          max=255)
        keep = (a == 0) | (a == 255)
        out = torch.cat([torch.where(keep, out[..., :3], div), a], dim=-1)
    return out.to(torch.uint8)


def _check_axis(bounds, tile, n_in):
    """Each position's taps inside its tile's span, and the spans inside
    the input; returns the spans' lengths."""
    lo, hi = R.tile_spans(bounds, tile)
    t = np.arange(bounds.shape[0]) // tile
    first, taps = bounds[:, 0].astype(np.int64), bounds[:, 1]
    assert (taps >= 1).all()
    assert (lo[t] <= first).all() and (first + taps <= hi[t]).all()
    assert (lo >= 0).all() and (hi <= n_in).all()
    return hi - lo


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tile_plan_spans_hold_every_tap_and_fit(shape):
    (in_w, in_h), (w, h), c = SHAPES[shape]
    plan = R.tile_plan(in_h, in_w, h, w, c)
    tw, th = plan.tile_w, plan.tile_h
    assert tw in R.TILE_WIDTHS and th in R.TILE_HEIGHTS
    assert plan.grid == (-(-w // tw), -(-h // th))
    xb, _, xks = R.coefficients(in_w, w)
    yb, _, yks = R.coefficients(in_h, h)
    widths = _check_axis(xb, tw, in_w)
    heights = _check_axis(yb, th, in_h)
    assert heights.max() <= plan.rows
    # a row's span starts at any offset within a 16-byte chunk
    chunked = [-(-(off + int(widths.max()) * c) // 16) * 16
               for off in range(16)]
    assert plan.row_bytes % 16 == 0 and max(chunked) <= plan.row_bytes
    most = int(max(xb[:, 1].max(), yb[:, 1].max()))
    assert plan.taps in R.TAPS_UNROLLED + (0,)
    assert most <= plan.taps or (plan.taps == 0
                                 and most > max(R.TAPS_UNROLLED))
    assert plan.smem == R.smem_bytes(c, tw, th, plan.rows, plan.row_bytes,
                                     xks, yks, plan.taps) <= R.SMEM_MAX
    img = _image(in_w, in_h, c, seed=sum(map(ord, shape)))
    want = R.resize_bilinear_plain(img, (w, h))
    assert torch.equal(_resize_by_tiles(img, (w, h), plan), want)


def test_tile_plan_at_the_truck_and_full_mip360_shapes():
    """Several output pixels a thread, at least two waves of four blocks
    an SM on 132 SMs, and four blocks' shared memory on an SM, at both
    shapes the main path and the -r -1 rule give."""
    for (in_w, in_h), (w, h), c in (SHAPES["truck"], SHAPES["mip360_full"]):
        plan = R.tile_plan(in_h, in_w, h, w, c)
        assert plan.tile_w * plan.tile_h >= 2 * R.THREADS
        assert plan.grid[0] * plan.grid[1] >= R.MIN_BLOCKS
        assert plan.smem <= R.SMEM_TARGET


def test_tile_plan_raises_where_no_tile_fits():
    with pytest.raises(ValueError, match="no tile"):
        R.tile_plan(5000, 5000, 1, 1, 4)
