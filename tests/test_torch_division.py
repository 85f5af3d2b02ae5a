"""Port parity of the row division (grendel_tpu_torch/parallel/division.py
against grendel_tpu/parallel/division.py): every function gives the same
numpy output, exactly, on balanced, skewed (the per-device row cap binds)
and border-snapped cases, as tests/test_parallel.py states them, and on
random heuristics from numpy seeds."""

import numpy as np
import pytest

from grendel_tpu.parallel import division as J
from grendel_tpu.testing import make_test_camera as j_camera
from grendel_tpu_torch.parallel import division as T
from grendel_tpu_torch.testing import make_test_camera as t_camera


def _skewed():
    h = np.zeros(16)
    h[:2] = 100.0
    return h


def _border(scale):
    h = np.ones(20)
    h[:11 if scale < 1 else 9] = scale
    return h


DIVIDE_CASES = {
    "balanced": (np.ones(24), 4, 8, {}),
    "skewed_cap": (_skewed(), 4, 8, {}),
    "border_no_snap": (_border(0.9), 2, 20, {}),
    "border_snap_down": (_border(0.9), 2, 20,
                         dict(rows_per_image=10, border_coeff=1.0)),
    "border_snap_up": (_border(1.3), 2, 20,
                       dict(rows_per_image=10, border_coeff=1.0)),
    "border_interior": (np.ones(20), 4, 20,
                        dict(rows_per_image=10, border_coeff=1.0)),
    "random": (np.random.default_rng(0).exponential(1.0, 53), 5, 14, {}),
    "random_snap": (np.random.default_rng(1).exponential(1.0, 60), 6, 12,
                    dict(rows_per_image=20, border_coeff=2.0)),
}


@pytest.mark.parametrize("name", sorted(DIVIDE_CASES))
def test_divide_rows_matches_jax(name):
    h, d, cap, kw = DIVIDE_CASES[name]
    got = T.divide_rows(h, d, cap, **kw)
    want = J.divide_rows(h, d, cap, **kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if name == "skewed_cap":
        assert got[1] <= 2 and np.all(np.diff(got) <= cap)
    if name == "border_snap_down":
        assert got[1] == 10
    for i in range(d):
        assert T.rows_of_device(got, i) == J.rows_of_device(want, i)


@pytest.mark.parametrize("bsz,tiles_y,d", [(2, 4, 2), (4, 3, 2), (2, 5, 4),
                                           (3, 7, 3)])
def test_divide_rows_whole_images_matches_jax(bsz, tiles_y, d):
    np.testing.assert_array_equal(T.divide_rows_whole_images(bsz, tiles_y, d),
                                  J.divide_rows_whole_images(bsz, tiles_y, d))


def test_division_history_matches_jax():
    rng = np.random.default_rng(2)
    hists = (T.DivisionHistory(tiles_y=4, decay=0.6),
             J.DivisionHistory(tiles_y=4, decay=0.6))
    cams = [[f(32, 32, angle=a) for a in (0.0, 0.3, 0.6)]
            for f in (t_camera, j_camera)]
    for cs in cams:
        for uid, c in zip((10, 11, 12), cs):
            c.uid = uid
    for step in range(3):
        batch = [0, 1] if step != 1 else [2, 1]
        pos = np.array([0, 3, 8], np.int32)
        costs = rng.uniform(0.5, 4.0, (2, 8))
        for hist, cs in zip(hists, cams):
            bc = [cs[i] for i in batch]
            hist.update(bc, pos, costs)
        np.testing.assert_array_equal(
            hists[0].heuristic_for([cams[0][i] for i in (0, 1, 2)]),
            hists[1].heuristic_for([cams[1][i] for i in (0, 1, 2)]))


def test_pack_gt_rows_matches_jax():
    h, w, tile_h = 40, 32, 16            # tiles_y 3, the last row half-padded
    rng = np.random.default_rng(3)
    gts = rng.integers(0, 255, (2, 3, h, w), dtype=np.uint8)
    cams = [[f(w, h, angle=a) for a in (0.0, 0.2)] for f in (t_camera,
                                                             j_camera)]
    for cs in cams:
        for c, g in zip(cs, gts):
            c.gt_image_u8 = g
    for pos, d, max_rows in (([0, 2, 6], 2, 4), ([0, 1, 1, 6], 3, 5)):
        pos = np.array(pos, np.int32)
        got = T.pack_gt_rows(cams[0], pos, d, max_rows, tile_h, h, w)
        want = J.pack_gt_rows(cams[1], pos, d, max_rows, tile_h, h, w)
        np.testing.assert_array_equal(got, want)
        over = T.pack_gt_rows(cams[0], pos, d, max_rows, tile_h, h, w,
                              gt_override=list(gts[::-1]))
        np.testing.assert_array_equal(over, J.pack_gt_rows(
            cams[1], pos, d, max_rows, tile_h, h, w,
            gt_override=list(gts[::-1])))


@pytest.mark.parametrize("path", ["device", "host"])
@pytest.mark.parametrize("pos", [[0, 1, 4, 6], [0, 3, 3, 6]])
def test_device_gt_rows_match_jax_pack(pos, path):
    """The multi-rank loop's ground-truth rows of each rank
    (engine/trainer_dist.py ``MultiRankTrainer._gt_rows``): gathered on
    its device from a preloaded bank, or packed on the host over its own
    span and uploaded (the JAX package's per-process pack): at an uneven
    division of 2 cameras of 3 tile rows (the last half-padded) over 3
    ranks, one of them empty in the second case, every rank's rows equal
    grendel_tpu's ``pack_gt_rows``."""
    import types

    import torch

    from grendel_tpu_torch.engine.trainer import PinnedUpload
    from grendel_tpu_torch.engine.trainer_dist import MultiRankTrainer
    from grendel_tpu_torch.parallel.sharded import ParallelConfig

    h, w, tile_h, d, max_rows = 40, 32, 16, 3, 4
    gts = np.random.default_rng(5).integers(0, 255, (3, 3, h, w),
                                            dtype=np.uint8)
    cams = [j_camera(w, h, angle=a) for a in (0.0, 0.2, 0.4)]
    t_cams = [t_camera(w, h, angle=a) for a in (0.0, 0.2, 0.4)]
    for c, tc, g in zip(cams, t_cams, gts):
        c.gt_image_u8 = tc.gt_image_u8 = g
    batch = [cams[2], cams[0]]               # bank indices 2 and 0
    want = J.pack_gt_rows(batch, np.array(pos, np.int32), d, max_rows,
                          tile_h, h, w)
    loop = types.SimpleNamespace(
        cfg=types.SimpleNamespace(pipeline=types.SimpleNamespace(
            tile_h=tile_h)),
        _tiles_y=3, img_h=h, img_w=w, device=torch.device("cpu"),
        _upload_gt=PinnedUpload(torch.device("cpu")))
    loop._gt_bank = (MultiRankTrainer._make_gt_bank(loop, t_cams)
                     if path == "device" else None)
    pcfg = ParallelConfig(n_devices=d, bsz=2, img_h=h, img_w=w,
                          tile_h=tile_h, n_row_slots=max_rows)
    for rank in range(d):
        loop.rank = rank
        got = MultiRankTrainer._gt_rows(loop, [t_cams[2], t_cams[0]],
                                        torch.tensor([2, 0]),
                                        np.array(pos), pcfg)
        np.testing.assert_array_equal(got.numpy(), want[rank])
