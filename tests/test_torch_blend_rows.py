"""K1's and K2's wrapper logic that runs without a card: the (M, 9)
gradient rows K2s writes are sliced back into the four gradients, and off
the CPU each wrapper refuses a tile its kernel does not take before it
launches, and passes on every tile its kernel takes: K2 every multiple of
32 pixels, narrow ones too; K1 every tile of 1 to 1024 pixels."""

import numpy as np
import pytest
import torch

from grendel_tpu_torch.ops.rasterize_cuda import (BWD_ROW, BWD_WARP,
                                                  MAX_PIXELS,
                                                  rasterize_slots_fwd,
                                                  rasterize_slots_vjp,
                                                  split_grads)


def test_kernel_rows_split_into_the_four_gradients():
    """K2s sums each Gaussian's entry rows into a 9-float row; the wrapper
    hands back columns 0-1, 2-4, 5-7 and 8 as d_means2d, d_conics,
    d_colors and d_opacities."""
    rows = torch.arange(5 * BWD_ROW, dtype=torch.float32).reshape(5, BWD_ROW)
    d_m, d_c, d_rgb, d_o = split_grads(rows)
    assert (d_m.shape, d_c.shape, d_rgb.shape, d_o.shape) == (
        (5, 2), (5, 3), (5, 3), (5,))
    np.testing.assert_array_equal(
        torch.cat([d_m, d_c, d_rgb, d_o[:, None]], 1).numpy(),
        rows[:, :9].numpy())


def test_backward_wrapper_refuses_what_its_kernel_does_not_take():
    """Off the CPU, K2's wrapper raises for a tile whose pixel count is not
    a multiple of its 32-lane warp, and for a device without a kernel. The
    tiles the parent design took (any multiple of 32 pixels up to 1024,
    such as 64x4, 32x4 and 128x2) reach the device check."""
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device="meta")
    i32 = lambda *s: z(*s, dt=torch.int32)

    def vjp(tile_w, tile_h):
        p = tile_w * tile_h
        rasterize_slots_vjp(z(4, 2), z(4, 3), z(4, 3), z(4), i32(8), i32(3),
                            i32(2), i32(2), tile_w, tile_h, 64,
                            c_total=z(2, p, 3), final_t=z(2, p),
                            g=z(2, p, 3), g_t=z(2, p))

    for tile in ((12, 12), (5, 4), (16, 3)):
        assert (tile[0] * tile[1]) % BWD_WARP
        with pytest.raises(ValueError, match=f"multiple of {BWD_WARP}"):
            vjp(*tile)
    for tile in ((16, 16), (32, 16), (32, 8), (64, 4), (32, 4), (128, 2),
                 (32, 1), (12, 16), (3, 32)):
        with pytest.raises(ValueError, match="no blend kernel"):
            vjp(*tile)


def test_forward_wrapper_takes_every_tile_up_to_1024_pixels():
    """Off the CPU, K1's wrapper raises for a tile of 0 or more than 1024
    pixels before it looks at the device, and takes every tile in between
    to the device check: multiples of 32 (a warp patch each) and the rest
    (one pixel a thread), such as 12x10 and 8x2."""
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device="meta")
    i32 = lambda *s: z(*s, dt=torch.int32)

    def fwd(tile_w, tile_h):
        rasterize_slots_fwd(z(4, 2), z(4, 3), z(4, 3), z(4), i32(8), i32(3),
                            i32(2), i32(2), tile_w, tile_h, 64)

    for tile in ((0, 16), (16, 0), (1025, 1), (41, 25), (32, 33)):
        assert not 1 <= tile[0] * tile[1] <= MAX_PIXELS
        with pytest.raises(ValueError, match=f"1..{MAX_PIXELS}"):
            fwd(*tile)
    for tile in ((32, 16), (16, 16), (32, 8), (64, 4), (128, 2), (12, 16),
                 (12, 10), (8, 2), (1, 1), (5, 7), (31, 33), (32, 32),
                 (1024, 1), (1, 1024)):
        with pytest.raises(ValueError, match="no blend kernel"):
            fwd(*tile)
