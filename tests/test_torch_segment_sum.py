"""Port parity of the backward blend's reduction, split as the card runs it:
per-entry rows (the plain version of kernel K2,
``rasterize_slots_bwd_rows``) summed per Gaussian in entry order
(``segment_sum_rows``, the plain version of kernel K2s), on inputs made
from numpy seeds.

Tolerances:
  * ``segment_sum_rows`` against ``jax.ops.segment_sum``: each column
    within 1e-6 of its largest value (the two add in another order);
    against a serial numpy sum in entry order (``np.add.at``), and through
    the K2s wrapper on CPU tensors: bit-equal, the order K2s sums in; on
    camera-blocked lists and on heavy-tailed segment lengths (a segment of
    6,000 entries, mostly empty Gaussians, ids beyond both ends);
  * the per-entry rows against the reference's per-entry gradients
    (``d_entries`` of grendel_tpu/ops/rasterize_pallas.py _core_bwd), read
    without editing JAX: every entry is given a Gaussian of its own, so
    the Pallas blend's segment sum (interpret mode) returns each entry's
    row. No pixel saturates, so the bound is the unsaturated one of
    tests/test_torch_blend_bwd.py: 2e-5 of each column's largest value;
  * the split VJP on two cameras' blocked lists, whose block tails carry
    the sentinel, against the Pallas blend with ``seg_blocks=2``: the same
    2e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from grendel_tpu.cameras import camera_arrays as j_cam
from grendel_tpu.ops.isect import isect_tile_rows_blocked as j_blocked
from grendel_tpu.ops.rasterize_pallas import rasterize_slots_pl
from grendel_tpu_torch.ops.rasterize_cuda import segment_sum
from grendel_tpu_torch.ops.rasterize_torch import (rasterize_slots,
                                                   rasterize_slots_bwd,
                                                   rasterize_slots_bwd_rows,
                                                   segment_sum_rows)
from grendel_tpu_torch.testing import make_test_camera, random_gaussians
from tests.test_torch_blend_bwd import (H, NAMES, TILE, TX, TY, W,
                                        _project, _scaled_close, _scene)


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocked_rows(seed, n_cams=3, block=4000, m_per_cam=700):
    """Rows and ids in the camera-blocked layout: camera c's entries at
    [c*block, (c+1)*block) name Gaussians [c*m, (c+1)*m), each block's
    tail carries the sentinel (the universe size), and a few ids lie
    below 0 or past the sentinel. Row magnitudes span six decades."""
    rng = np.random.default_rng(seed)
    m = n_cams * m_per_cam
    ids = np.full(n_cams * block, m, np.int32)
    for c in range(n_cams):
        used = rng.integers(block // 2, block)
        ids[c * block:c * block + used] = (
            c * m_per_cam + rng.integers(0, m_per_cam, used))
    stray = rng.choice(ids.shape[0], 20, replace=False)
    ids[stray[:10]] = -rng.integers(1, 5, 10)
    ids[stray[10:]] = m + rng.integers(1, 5, 10)
    rows = (rng.standard_normal((ids.shape[0], 9))
            * 10.0 ** rng.integers(-3, 3, (ids.shape[0], 1))
            ).astype(np.float32)
    return rows, ids, m


def _heavy_tailed_rows(case, seed=7):
    """Rows and ids in a random entry order with heavy-tailed segment
    lengths, as the 4K step gives K2s: ``long_segment``, one Gaussian of
    6,000 entries among 800; ``mostly_empty``, 50,000 Gaussians of which
    300 have entries; ``beyond_both_ends``, a fifth of the ids below 0 or
    at or past M, out to the int32 extremes. Row magnitudes span six
    decades."""
    rng = np.random.default_rng(seed)
    if case == "long_segment":
        m = 800
        lengths = np.minimum((rng.pareto(1.2, m) * 2.0).astype(np.int64),
                             600)
        lengths[rng.random(m) < 0.3] = 0
        lengths[517] = 6000
        ids = np.repeat(np.arange(m, dtype=np.int32), lengths)
    elif case == "mostly_empty":
        m = 50_000
        ids = rng.choice(m, 300, replace=False).astype(np.int32).repeat(
            rng.integers(1, 40, 300))
    else:
        m = 3000
        ids = rng.integers(0, m, 20_000, dtype=np.int32)
        stray = rng.random(ids.shape[0]) < 0.2
        ids[stray] = rng.choice(np.array(
            [-2**31, -7, -1, m, m + 1, m + 999, 2**31 - 1], np.int32),
            int(stray.sum()))
    ids = rng.permutation(ids)
    rows = (rng.standard_normal((ids.shape[0], 9))
            * 10.0 ** rng.integers(-3, 3, (ids.shape[0], 1))
            ).astype(np.float32)
    return rows, ids, m


@pytest.mark.parametrize("case", [0, 1, "long_segment", "mostly_empty",
                                  "beyond_both_ends"])
def test_segment_sum_rows_matches_jax_segment_sum(case):
    rows, ids, m = (_blocked_rows(case) if isinstance(case, int)
                    else _heavy_tailed_rows(case))
    got = segment_sum_rows(torch.from_numpy(rows), torch.from_numpy(ids),
                           m).numpy()
    want = np.asarray(jax.ops.segment_sum(
        jnp.asarray(rows), jnp.asarray(ids), num_segments=m))
    scale = np.abs(want).max(axis=0) + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-6, rtol=0)
    # serially in entry order: the order K2s sums in, bit for bit
    serial = np.zeros((m + 1, 9), np.float32)
    np.add.at(serial, np.where((ids >= 0) & (ids < m), ids, m), rows)
    np.testing.assert_array_equal(got, serial[:m])
    # the K2s wrapper takes the plain version on CPU tensors, given the
    # ids' stable sort as the VJP gives it
    order = torch.sort(torch.from_numpy(ids), stable=True)
    via = segment_sum(torch.from_numpy(rows), m, order)
    np.testing.assert_array_equal(via.numpy(), got)
    assert segment_sum.launches == 0


def test_segment_sum_wrapper_refuses_a_device_without_a_kernel():
    z = torch.zeros(8, 9, device="meta")
    order = (torch.zeros(8, dtype=torch.int32, device="meta"),
             torch.zeros(8, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="no segment-sum kernel"):
        segment_sum(z, 4, order)


def _port_rows(args, mpt, t_weight):
    m2d, con, col, op, ids, toff, px0, py0 = (torch.tensor(a) for a in args)
    c, t = rasterize_slots(m2d, con, col, op, ids, toff, px0, py0, TILE,
                           TILE, mpt)
    return rasterize_slots_bwd_rows(
        m2d, con, col, op, ids, toff, px0, py0, TILE, TILE, mpt,
        c_total=c, final_t=t, g=2.0 * c, g_t=2.0 * t_weight * t).numpy()


@pytest.mark.parametrize("n,seed,mpt", [(300, 0, 256), (500, 1, 64)])
def test_plain_rows_match_pallas_per_entry_gradients(n, seed, mpt):
    args = _scene(n, seed)
    got = _port_rows(args, mpt, 0.7)
    m2d, con, col, op, ids, toff, px0, py0 = args
    m, e = m2d.shape[0], ids.shape[0]
    # one Gaussian per entry: the segment sum then keeps each entry's row
    valid = (ids >= 0) & (ids < m)
    src = np.where(valid, ids, 0)
    own = np.where(valid, np.arange(e, dtype=np.int32), e).astype(np.int32)
    leaves = [jnp.asarray(x[src]) for x in (m2d, con, col, op)]

    def loss(*leaves):
        c, t = rasterize_slots_pl(*leaves, jnp.asarray(own),
                                  jnp.asarray(toff), jnp.asarray(px0),
                                  jnp.asarray(py0), TILE, TILE, mpt,
                                  interpret=True)
        return jnp.sum(c * c) + 0.7 * jnp.sum(t * t)

    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*leaves)
    want = np.concatenate([np.asarray(x).reshape(e, -1) for x in g], 1)
    assert np.abs(want).max() > 0 and (np.abs(got).max(axis=1) > 0).sum() > 50
    scale = np.abs(want).max(axis=0) + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-5, rtol=0)


def test_split_vjp_matches_pallas_on_blocked_lists():
    """Two cameras' camera-blocked lists (a block tail of sentinels in
    each), the reference's seg_blocks=2 reduction against the port's
    rows and entry-order sum."""
    n_cams, n = 2, 300
    g = random_gaussians(4, n, sh_degree=3)
    projected = []
    for angle in (0.0, 0.4):
        ca = j_cam(make_test_camera(width=W, height=H, angle=angle))
        projected.append(_project(*(jnp.asarray(x) for x in g), ca.viewmat,
                                  ca.full_proj, ca.campos, ca.tanfov))
    flat = [jnp.concatenate([getattr(p, f) for p in projected])
            for f in ("means2d", "conics", "colors", "opacities", "radii",
                      "depths")]
    isect = jax.jit(j_blocked, static_argnums=range(3, 9))(
        flat[0], flat[4], flat[5], n_cams, TILE, TILE, TX, TY, n_cams * 1024,
        opacities=flat[3])
    ids = np.asarray(isect.gauss_ids)
    lo, hi = np.asarray(isect.tile_lo), np.asarray(isect.tile_hi)
    assert (ids == n_cams * n).any()                  # sentinel tails
    assert int(isect.num_isects) <= n_cams * 1024     # nothing dropped
    t_ids = np.arange(n_cams * TX * TY, dtype=np.int32) % (TX * TY)
    px0, py0 = (t_ids % TX) * TILE, (t_ids // TX) * TILE

    def loss(m2d, con, col, op):
        c, t = rasterize_slots_pl(m2d, con, col, op, jnp.asarray(ids), None,
                                  jnp.asarray(px0), jnp.asarray(py0), TILE,
                                  TILE, 256, interpret=True,
                                  tile_lo=jnp.asarray(lo),
                                  tile_hi=jnp.asarray(hi), seg_blocks=n_cams)
        return jnp.sum(c * c) + 0.7 * jnp.sum(t * t)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*flat[:4])
    m2d, con, col, op = (torch.tensor(np.asarray(x)) for x in flat[:4])
    spans = dict(tile_lo=torch.tensor(lo), tile_hi=torch.tensor(hi))
    pix = (torch.tensor(px0), torch.tensor(py0))
    c, t = rasterize_slots(m2d, con, col, op, torch.tensor(ids), None, *pix,
                           TILE, TILE, 256, **spans)
    got = rasterize_slots_bwd(m2d, con, col, op, torch.tensor(ids), None,
                              *pix, TILE, TILE, 256, **spans, c_total=c,
                              final_t=t, g=2.0 * c, g_t=1.4 * t)
    assert float(t.min()) > 1e-2                      # no pixel saturates
    _scaled_close([x.numpy() for x in got], [np.asarray(x) for x in want],
                  2e-5, "pallas, blocked")
    assert len(got) == len(NAMES)
