"""Port parity of the flat row-span tile lists (grendel_tpu_torch's
ops/isect.py isect_tile_rows against grendel_tpu's): on the same entries
from a mix of cameras (numpy seeds, distinct depths, since jax.lax.sort is
not stable), the tile offsets, Gaussian ids, num_isects and num_kept are
identical, for a span inside one camera, one across a camera border, and
an empty one, with and without the opacity-aware cull, while num_isects
stays below the capacity."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from grendel_tpu.ops.isect import isect_tile_rows as j_rows
from grendel_tpu_torch.ops.isect import isect_tile_rows as t_rows

TW, TH, W, H, B, M = 16, 16, 96, 80, 3, 900
TX, TY = -(-W // TW), -(-H // TH)      # 6 x 5 tiles, 15 global rows
CAPACITY = 1 << 14


def _entries(seed):
    """M received entries of B cameras: means in and around the image,
    radii 0-40 px (a tenth culled), distinct depths, opacities."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-20, W + 20, M),
                      rng.uniform(-20, H + 20, M)], -1).astype(np.float32)
    radii = rng.integers(1, 40, M).astype(np.int32)
    radii[rng.random(M) < 0.1] = 0
    depths = rng.permutation(M).astype(np.float32) * 0.01 + 1.0
    depths[radii == 0] = np.inf
    cams = rng.integers(0, B, M).astype(np.int32)
    opac = rng.uniform(0.002, 0.99, M).astype(np.float32)
    return means, radii, depths, cams, opac


SPANS = {
    "inside_a_camera": (6, 9, 4),        # camera 1, tile rows 1-3
    "across_a_border": (3, 8, 6),        # camera 0 rows 3-4, camera 1 rows 0-2
    "empty": (9, 9, 4),
}


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("span", sorted(SPANS))
def test_isect_tile_rows_matches_jax(span, cull):
    lo, hi, slots = SPANS[span]
    means, radii, depths, cams, opac = _entries(5 + cull)
    got = t_rows(torch.from_numpy(means), torch.from_numpy(radii),
                 torch.from_numpy(depths), torch.from_numpy(cams),
                 torch.tensor(lo, dtype=torch.int32),
                 torch.tensor(hi, dtype=torch.int32), TW, TH, TX, TY, slots,
                 CAPACITY, opacities=torch.from_numpy(opac) if cull else None)
    want = j_rows(jnp.asarray(means), jnp.asarray(radii),
                  jnp.asarray(depths), jnp.asarray(cams), jnp.int32(lo),
                  jnp.int32(hi), TW, TH, TX, TY, slots, CAPACITY,
                  opacities=jnp.asarray(opac) if cull else None)
    n = int(want.num_isects)
    assert n < CAPACITY and int(got.num_isects) == n
    assert (n == 0) == (span == "empty")
    assert int(got.num_kept) == int(want.num_kept)
    np.testing.assert_array_equal(got.tile_offsets.numpy(),
                                  np.asarray(want.tile_offsets))
    np.testing.assert_array_equal(got.gauss_ids.numpy(),
                                  np.asarray(want.gauss_ids))
    assert got.tile_offsets.shape == (slots * TX + 1,)
    if cull:    # the corner cull dropped entries
        assert span == "empty" or int(got.num_kept) < n
