"""Port parity of the distributed step's per-rank pieces
(grendel_tpu_torch/parallel/sharded.py against
grendel_tpu/parallel/sharded.py), from numpy seeds:

  * the pack (pack_for_exchange), each of 4 ranks' run on its own and the
    buckets moved rank to rank by an index, against JAX's
    _route_pack_exchange in shard_map on a 4-device slice of the mesh: the
    received payload and metadata equal, and each rank's overflow and
    demand, also with a send_cap below the demand;
  * render_owned_rows on the flat row-span lists (the kernel wrappers,
    which take their plain versions on the CPU), with and without the
    entry compaction of blend_capacity, against JAX's _render_owned_rows
    with backend "jax", on an unsaturated scene: rows within 1e-5, the
    mask, camera of each row, entries per row and the entry counts equal;
  * row_span_loss on rows near a smooth ground truth: values within 1e-5
    relative (float32 sums of 13,440 SSIM values in two libraries' orders:
    4.7e-6 measured on this input, 9.5e-6 on uniform noise), its gradient
    within 1e-4 of its largest, the whole-step gradient bound of
    tests/test_torch_train.py (4.9e-5 measured: SSIM's variance terms
    cancel in float32);
  * normalize_grads_by_visibility, each mode, within 1e-7.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from grendel_tpu.models.gaussian_model import GaussianParams as JParams
from grendel_tpu.parallel import sharded as JS
from grendel_tpu_torch import testing
from grendel_tpu_torch.cameras import batch_camera_arrays
from grendel_tpu_torch.convert import params_from_numpy
from grendel_tpu_torch.models.gaussian_model import GaussianParams
from grendel_tpu_torch.parallel import sharded as TS

FIELDS = GaussianParams._fields


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ the pack

D, B, N_LOC, H, W = 4, 2, 300, 80, 64


def _rank_splats(seed):
    """One rank's projected splats (B, N_LOC, ...) as numpy: a tenth culled,
    radii up to 40 px, so many boxes span several ranks' rows."""
    rng = np.random.default_rng(seed)
    radii = rng.integers(1, 40, (B, N_LOC)).astype(np.int32)
    radii[rng.random((B, N_LOC)) < 0.1] = 0
    depths = rng.uniform(1.0, 5.0, (B, N_LOC)).astype(np.float32)
    depths[radii == 0] = np.inf
    f32 = np.float32
    return (np.stack([rng.uniform(-10, W + 10, (B, N_LOC)),
                      rng.uniform(-10, H + 10, (B, N_LOC))], -1).astype(f32),
            rng.uniform(0.01, 0.5, (B, N_LOC, 3)).astype(f32),
            rng.uniform(0, 1, (B, N_LOC, 3)).astype(f32),
            rng.uniform(0.1, 0.9, (B, N_LOC)).astype(f32), radii, depths)


@pytest.mark.parametrize("send_cap", [B * N_LOC, 96])
def test_pack_and_exchange_match_jax(send_cap, eight_devices):
    ranks = [_rank_splats(10 + r) for r in range(D)]
    pos = np.array([0, 2, 5, 6, 10], np.int32)      # uneven, 5 rows a camera
    jcfg = JS.ParallelConfig(n_devices=D, bsz=B, img_h=H, img_w=W,
                             send_cap=send_cap)
    tcfg = TS.ParallelConfig(n_devices=D, bsz=B, img_h=H, img_w=W,
                             send_cap=send_cap)
    mesh = Mesh(np.array(eight_devices[:D]), ("d",))

    def shard(*args):
        *x, division_pos = args
        out = JS._route_pack_exchange(*(a[0] for a in x), division_pos, jcfg)
        return tuple(o[None] for o in out)

    fn = jax.jit(shard_map(shard, mesh=mesh,
                           in_specs=(P("d"),) * 6 + (P(),),
                           out_specs=(P("d"),) * 4, check_vma=False))
    stacked = [jnp.asarray(np.stack(x)) for x in zip(*ranks)]
    j_pay, j_meta, j_over, j_dem = jax.device_get(
        fn(*stacked, jnp.asarray(pos)))

    sends = [TS.pack_for_exchange(*(torch.from_numpy(a) for a in r),
                                  torch.from_numpy(pos), tcfg)
             for r in ranks]
    for r in range(D):
        recv_p = torch.stack([s[0][r] for s in sends]).reshape(-1, 9)
        recv_m = torch.stack([s[1][r] for s in sends]).reshape(-1, 4)
        np.testing.assert_array_equal(recv_p.numpy(), j_pay[r])
        np.testing.assert_array_equal(recv_m.numpy(), j_meta[r])
        assert int(sends[r][2]) == int(j_over[r])
        assert int(sends[r][3]) == int(j_dem[r])
    overflow = int(np.sum(j_over))
    assert (overflow > 0) == (send_cap < B * N_LOC), overflow
    assert int(np.max(j_dem)) > (96 if send_cap < B * N_LOC else 0)


def test_pack_payload_carries_the_gradient():
    """The payload is differentiable: each bucket slot's gradient returns
    to the (camera, Gaussian) it came from, once for every rank it went
    to; the metadata carries none."""
    means, con, rgb, op, radii, depths = (torch.from_numpy(a)
                                          for a in _rank_splats(3))
    means.requires_grad_(True)
    cfg = TS.ParallelConfig(n_devices=D, bsz=B, img_h=H, img_w=W,
                            send_cap=B * N_LOC)
    pos = torch.tensor([0, 2, 5, 6, 10], dtype=torch.int32)
    send_p, send_m, _, _ = TS.pack_for_exchange(means, con, rgb, op, radii,
                                                depths, pos, cfg)
    assert not send_m.requires_grad
    g, = torch.autograd.grad(send_p[..., 0].sum(), [means])
    copies = (send_m[..., 3] > 0).sum()
    assert float(g[..., 0].sum()) == float(copies) > B * N_LOC * 0.9
    assert float(g[..., 1].abs().sum()) == 0.0
    assert set(g[..., 0].unique().tolist()) <= {0.0, 1.0, 2.0, 3.0, 4.0}


# --------------------------------------------------------- the owned rows

RH, RW, RB = 80, 96, 2


@pytest.fixture(scope="module")
def received():
    """A whole camera-major universe of 2 cameras, projected by the port
    from numpy Gaussians (300 live, opacities 0.3-0.95: no pixel
    saturates), as numpy payload and metadata."""
    fields, alive = testing.params_fields(
        *testing.random_gaussians(7, 300, sh_degree=1), 384)
    params, alive_t = params_from_numpy(fields, alive, "cpu")
    cams = batch_camera_arrays([testing.make_test_camera(RW, RH, angle=a)
                                for a in (0.0, 0.4)], "cpu")
    cfg = TS.ParallelConfig(n_devices=1, bsz=RB, img_h=RH, img_w=RW)
    with torch.no_grad():
        s = TS.project_batch(params, alive_t, cams, cfg, 1)
        payload, meta = TS.payload_and_meta(s.means2d, s.conics, s.colors,
                                            s.opacities, s.radii, s.depths)
    return payload.numpy(), meta.numpy()


ROW_CASES = {                      # (row_lo, row_hi, n_row_slots)
    "a whole camera and slack": (0, 5, 7),
    "across the border": (3, 8, 5),
    "the last rows": (8, 10, 4),
}


# 0: the whole list; 768: compacted (compact_entries_flat) to a budget
# above the at most 651 entries of these spans
@pytest.mark.parametrize("blend_capacity", [0, 768])
@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_render_owned_rows_matches_jax(received, case, blend_capacity):
    lo, hi, slots = ROW_CASES[case]
    payload, meta = received
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    kw = dict(n_devices=3, bsz=RB, img_h=RH, img_w=RW, n_row_slots=slots,
              isect_capacity=1 << 14, blend_capacity=blend_capacity,
              max_per_tile=512)
    jcfg = JS.ParallelConfig(**kw, backend="jax").resolved(128)
    tcfg = TS.ParallelConfig(**kw).resolved(128)
    want = JS._render_owned_rows(jnp.asarray(payload), jnp.asarray(meta),
                                 jnp.int32(lo), jnp.int32(hi), jcfg,
                                 jnp.asarray(bg))
    got = TS.render_owned_rows(torch.from_numpy(payload),
                               torch.from_numpy(meta),
                               torch.tensor(lo, dtype=torch.int32),
                               torch.tensor(hi, dtype=torch.int32), tcfg,
                               torch.from_numpy(bg))
    assert int(want[4]) < 1 << 14
    np.testing.assert_allclose(got.rows.numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=0)
    for a, b in zip((got.mask, got.cam_of_row, got.per_row_entries,
                     got.num_isects, got.num_kept), want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got.per_row_entries.sum()) > 0


def test_row_span_loss_matches_jax():
    rng = np.random.default_rng(8)
    r_slots, th, w, bsz, img_h = 6, 16, 40, 2, 40     # tiles_y 3
    cfg_kw = dict(n_devices=2, bsz=bsz, img_h=img_h, img_w=w, tile_w=8,
                  tile_h=th)
    yy, xx = np.meshgrid(np.arange(r_slots * th), np.arange(w),
                         indexing="ij")
    gt = np.stack([0.5 + 0.4 * np.sin(xx / 5.0 + c) * np.cos(yy / 7.0)
                   for c in range(3)])
    gt = gt.reshape(3, r_slots, th, w).transpose(1, 0, 2, 3).astype(
        np.float32)
    rows = np.clip(gt + 0.05 * rng.standard_normal(gt.shape), 0, 1).astype(
        np.float32)
    row_ids = 1 + np.arange(r_slots)                 # rows 1..6, owned 1..5
    mask = ((row_ids < 6)[:, None, None]
            & ((row_ids % 3)[:, None] * th + np.arange(th) < img_h)[:, :,
                                                                    None])
    mask = np.broadcast_to(mask, (r_slots, th, w)).copy()
    cam = np.clip(row_ids // 3, 0, bsz - 1).astype(np.int32)
    want = JS._row_span_loss(jnp.asarray(rows), jnp.asarray(gt),
                             jnp.asarray(mask), jnp.asarray(cam),
                             JS.ParallelConfig(**cfg_kw), 0.2)
    j_grad = jax.grad(lambda x: JS._row_span_loss(
        x, jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(cam),
        JS.ParallelConfig(**cfg_kw), 0.2)[0])(jnp.asarray(rows))
    rows_t = torch.from_numpy(rows).requires_grad_(True)
    got = TS.row_span_loss(rows_t, torch.from_numpy(gt),
                           torch.from_numpy(mask), torch.from_numpy(cam),
                           TS.ParallelConfig(**cfg_kw), 0.2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-5)
    g, = torch.autograd.grad(got[0], [rows_t])
    sc = float(np.abs(j_grad).max())
    np.testing.assert_allclose(g.numpy() / sc, np.asarray(j_grad) / sc,
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["none", "divide_by_visible_count",
                                  "multiply_by_visible_count",
                                  "square_multiply_by_visible_count"])
def test_normalize_grads_by_visibility_matches_jax(mode):
    rng = np.random.default_rng(9)
    n, k = 50, 4
    shapes = dict(means3d=(n, 3), sh_dc=(n, 1, 3), sh_rest=(n, k - 1, 3),
                  scales_raw=(n, 3), quats=(n, 4), opacities_raw=(n,))
    grads = {f: rng.standard_normal(shapes[f]).astype(np.float32)
             for f in FIELDS}
    radii = rng.integers(0, 3, (3, n)).astype(np.int32)
    got = TS.normalize_grads_by_visibility(
        GaussianParams(**{f: torch.from_numpy(v) for f, v in grads.items()}),
        torch.from_numpy(radii), mode)
    want = JS.normalize_grads_by_visibility(
        JParams(**{f: jnp.asarray(v) for f, v in grads.items()}),
        jnp.asarray(radii), mode)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-7,
                                   err_msg=f)
    with pytest.raises(ValueError):
        TS.normalize_grads_by_visibility(got, torch.from_numpy(radii), "bogus")
