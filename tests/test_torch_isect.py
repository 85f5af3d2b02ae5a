"""Port parity: tile intersection of grendel_tpu_torch against grendel_tpu,
fed the same projected splats (numpy scene, JAX projection).

All outputs are integers and must be identical. Scene depths are distinct
(continuous random means), since JAX's (camera, depth) sort is not stable.
Past its spans JAX's flat list holds Gaussian ids (the corner cull's drops,
then the broadcast id of the last culled, depth +inf, Gaussian); the port's
writes the sentinel there, as both blocked lists do, so the flat
comparison covers the spans' ``num_kept`` entries and checks the sentinel
after them; the blocked list is compared whole.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from grendel_tpu.cameras import batch_camera_arrays
from grendel_tpu.ops import isect as J
from grendel_tpu.ops.projection import project_gaussians_batched
from grendel_tpu_torch.ops import isect as T
from grendel_tpu_torch.testing import make_test_camera, random_gaussians

H, W, TILE = 64, 96, 16
TX, TY = -(-W // TILE), -(-H // TILE)
# jitted: one compile instead of one per eager op
_j_project = jax.jit(project_gaussians_batched, static_argnums=(7, 8, 9))
_j_isect = jax.jit(J.isect_tiles, static_argnums=(3, 4, 5, 6, 7))
_j_blocked = jax.jit(J.isect_tile_rows_blocked,
                     static_argnums=(3, 4, 5, 6, 7, 8))


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores; torch's spinning intra-op
    threads would then slow every test on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _splats(n=400, b=2, seed=0):
    # large Gaussians: deep tile lists, and rect corners for the corner cull
    g = random_gaussians(seed, n, sh_degree=1, scale_range=(-3.5, -1.5))
    alive = np.arange(n) < n - 30              # dead slots: +inf depth ties
    cams = [make_test_camera(W, H, dist=4.0, angle=0.5 * i) for i in range(b)]
    s = _j_project(*(jnp.asarray(x) for x in g), jnp.asarray(alive),
                   batch_camera_arrays(cams), H, W, 1)
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def _args(s, cam=None):
    keys = ("means2d", "radii", "depths", "opacities")
    if cam is None:
        vals = [s[k].reshape((-1,) + s[k].shape[2:]) for k in keys]
    else:
        vals = [s[k][cam] for k in keys]
    return vals


def _eq(t, j, what):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j), err_msg=what)


@pytest.mark.parametrize("capacity", [1 << 14, 1200])
def test_isect_tiles_matches_jax(capacity):
    s = _splats()
    m2d, rad, dep, op = _args(s, cam=0)
    j = _j_isect(jnp.asarray(m2d), jnp.asarray(rad), jnp.asarray(dep),
                 TILE, TILE, TX, TY, capacity, opacities=jnp.asarray(op))
    t = T.isect_tiles(torch.tensor(m2d), torch.tensor(rad), torch.tensor(dep),
                      TILE, TILE, TX, TY, capacity, opacities=torch.tensor(op))
    total = int(j.num_isects)
    assert (total > capacity) == (capacity == 1200)   # the small one overflows
    _eq(t.num_isects, j.num_isects, "num_isects")
    _eq(t.num_kept, j.num_kept, "num_kept")
    assert int(j.num_kept) < min(total, capacity)     # the corner cull dropped
    _eq(t.tile_offsets, j.tile_offsets, "tile_offsets")
    # the spans' entries are JAX's; past them (the corner cull's drops,
    # then the unused capacity) the port writes the sentinel id, where
    # JAX's tail keeps Gaussian ids
    kept = int(j.num_kept)
    _eq(t.gauss_ids[:kept], j.gauss_ids[:kept], "gauss_ids")
    assert t.gauss_ids.shape == (capacity,)
    assert bool((t.gauss_ids[kept:] == m2d.shape[0]).all())
    assert t.gauss_ids.dtype == t.tile_offsets.dtype == torch.int32


def _blocked(s, capacity):
    m2d, rad, dep, op = _args(s)
    b = s["means2d"].shape[0]
    j = _j_blocked(jnp.asarray(m2d), jnp.asarray(rad), jnp.asarray(dep), b,
                   TILE, TILE, TX, TY, capacity, opacities=jnp.asarray(op))
    t = T.isect_tile_rows_blocked(
        torch.tensor(m2d), torch.tensor(rad), torch.tensor(dep), b,
        TILE, TILE, TX, TY, capacity, opacities=torch.tensor(op))
    for name in ("gauss_ids", "tile_lo", "tile_hi", "num_isects", "num_kept"):
        _eq(getattr(t, name), getattr(j, name), name)
    return t, j


def test_isect_tile_rows_blocked_matches_jax_with_overflow():
    s = _splats(seed=3)
    demand = [int(_j_isect(*(jnp.asarray(x) for x in _args(s, c)[:3]),
                           TILE, TILE, TX, TY, 1 << 14,
                           opacities=jnp.asarray(_args(s, c)[3])).num_isects)
              for c in range(2)]
    # room for both cameras
    _blocked(s, 2 * (max(demand) + 64))
    # a block between the two demands: one camera is truncated, one is not
    block = (demand[0] + demand[1]) // 2
    assert min(demand) <= block < max(demand)
    t, _ = _blocked(s, 2 * block)
    assert int(t.num_isects) == 2 * max(demand) > 2 * block


def test_compact_entries_match_jax():
    s = _splats(seed=4)
    bpc = 1 << 13
    t, j = _blocked(s, 2 * bpc)
    numt = TX * TY
    bbc = int(t.num_kept) // 2 + 8
    tc = T.compact_entries_blocked(t.gauss_ids, t.tile_lo, t.tile_hi, 2, numt,
                                   bpc, bbc)
    jc = J.compact_entries_blocked(j.gauss_ids, j.tile_lo, j.tile_hi, 2, numt,
                                   bpc, bbc)
    for a, b, name in zip(tc, jc, ("ids", "tile_lo", "tile_hi")):
        _eq(a, b, name)
    assert tc[0].shape == (2 * bbc,)
    toff = torch.tensor([0, 5, 9, 30], dtype=torch.int32)
    ids = torch.arange(40, dtype=torch.int32)
    tf = T.compact_entries_flat(ids, toff, 16)
    jf = J.compact_entries_flat(jnp.asarray(ids.numpy()), jnp.asarray(toff.numpy()), 16)
    _eq(tf[0], jf[0], "flat ids")
    _eq(tf[1], jf[1], "flat offsets")


def test_rect_and_cull_helpers_match_jax():
    rng = np.random.default_rng(9)
    n = 500
    m2d = rng.uniform(-40, 140, (n, 2)).astype(np.float32)
    rad = rng.integers(0, 60, n).astype(np.int32)
    op = rng.uniform(0.0, 1.0, n).astype(np.float32)
    rc_j = J.cull_radius(jnp.asarray(rad), jnp.asarray(op))
    rc_t = T.cull_radius(torch.tensor(rad), torch.tensor(op))
    # log and sqrt of the two libraries may differ in the last ulp
    np.testing.assert_allclose(rc_t.numpy(), np.asarray(rc_j), rtol=1e-6)
    rect_r = np.where(np.asarray(rc_j) < 0, np.asarray(rc_j),
                      np.minimum(np.asarray(rc_j), rad.astype(np.float32)))
    for rr in (None, rect_r):
        jr = J.gaussian_tile_rect(jnp.asarray(m2d), jnp.asarray(rad), 32, 16,
                                  5, 6, None if rr is None else jnp.asarray(rr))
        tr = T.gaussian_tile_rect(torch.tensor(m2d), torch.tensor(rad), 32, 16,
                                  5, 6, None if rr is None else torch.tensor(rr))
        for a, b in zip(tr, jr):
            _eq(a, b, "rect")
    pj = J._pack_cull(jnp.asarray(m2d[:, 0]), jnp.asarray(m2d[:, 1]), rc_j)
    pt = T._pack_cull(torch.tensor(m2d[:, 0]), torch.tensor(m2d[:, 1]),
                      torch.tensor(np.asarray(rc_j)))
    _eq(pt, pj, "packed cull")
    ex = rng.integers(0, 5, n).astype(np.int32)
    ey = rng.integers(0, 6, n).astype(np.int32)
    _eq(T._corner_cull_keep(torch.tensor(ex), torch.tensor(ey), pt, 32, 16),
        J._corner_cull_keep(jnp.asarray(ex), jnp.asarray(ey), pj, 32, 16),
        "corner cull")
