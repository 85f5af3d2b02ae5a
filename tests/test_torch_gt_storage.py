"""Port parity of host-resident ground truth: grendel_tpu_torch's
cameras.py ``DecodedLru`` / ``Camera.gt``, data/scene.py's
``decode_mask`` and PIL-free PNG decode, the training CLI's
``make_decode_mask``, and both loops' host paths (engine/trainer.py,
engine/trainer_dist.py) on the CPU.

The scene is the structured scene at 64x48 exported as a COLMAP + PNG
dataset (10 views, every 5th held out). The JAX package reads it with PIL
and the port with utils/png.py, so the decoded arrays must be equal; the
decode counts, the LRU's bytes and eviction order must be JAX's on the same
sequence of reads; and a loop that uploads its ground truth from the host
must train bit-equal to the same loop with the dataset preloaded.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from grendel_tpu import cameras as JCAM
from grendel_tpu.data import readers as JR
from grendel_tpu.data import scene as JS
from grendel_tpu.parallel import pack_gt_rows as j_pack
from grendel_tpu_torch import cameras as TCAM
from grendel_tpu_torch import testing
from grendel_tpu_torch.config import TrainConfig
from grendel_tpu_torch.data import readers as TR
from grendel_tpu_torch.data import scene as TS
from grendel_tpu_torch.engine.trainer import Trainer
from grendel_tpu_torch.parallel import comm
from grendel_tpu_torch.parallel.division import pack_gt_rows as t_pack
from grendel_tpu_torch.scripts import train as t_train

W, H, N_CAMS, HOLD = 64, 48, 10, 5


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from grendel_tpu_torch.scripts.export_structured_dataset import \
        export_structured_dataset

    d = str(tmp_path_factory.mktemp("structured"))
    export_structured_dataset(d, W, H, N_CAMS, 2000, 0, llffhold=HOLD)
    return d


def _lru_sequence(cam_mod, scene_cls, pack, d):
    """tests/test_data.py's lazy-decode and byte-budget sequences on one
    package (its cameras module, ``Scene`` and ``pack_gt_rows``): what the
    decode counter, the LRU's bytes and its order of cameras read after
    each step."""
    rec = []

    def count():
        return cam_mod.LAZY_DECODE_COUNT[0] - n0

    n0 = cam_mod.LAZY_DECODE_COUNT[0]
    cam_mod.GT_DECODE_CACHE.clear()
    half = scene_cls(d, eval_split=False, shuffle=False,
                     decode_mask=lambda i, ci: i % 2 == 0)
    cams = half.train_cameras
    rec.append(("stored", [c.gt_image_u8 is not None for c in cams]))
    img = cams[1].gt()
    cams[0].gt()                                   # stored: free
    rec.append(("lazy read", count(), img.shape))
    tiles_y = -(-H // 16)
    packs = [pack(cams[:2], np.array([0, tiles_y], np.int32), 1, tiles_y,
                  16, H, W)]                       # camera 0's rows only
    rec.append(("pack of stored rows", count()))
    for _ in range(5):                             # served from the LRU
        packs.append(pack(cams[:2], np.array([0, 2 * tiles_y], np.int32), 1,
                          2 * tiles_y, 16, H, W))
    rec.append(("packs from the cache", count()))
    cam_mod.GT_DECODE_CACHE.clear()
    packs.append(pack(cams[:2], np.array([0, 2 * tiles_y], np.int32), 1,
                      2 * tiles_y, 16, H, W))
    rec.append(("pack after clear", count()))

    lazy = scene_cls(d, eval_split=False, shuffle=False,
                     decode_mask=lambda i, ci: False)
    cams = lazy.train_cameras
    img_bytes = cams[0].gt().nbytes
    lru = cam_mod.DecodedLru(max_bytes=2 * img_bytes)
    old, cam_mod.GT_DECODE_CACHE = cam_mod.GT_DECODE_CACHE, lru

    def order():
        return [[i for i, c in enumerate(cams) if c is ref()][0]
                for ref, _ in lru._entries.values()]

    try:
        n0 = cam_mod.LAZY_DECODE_COUNT[0]
        for c in cams[:3]:
            c.gt()
        rec.append(("three decodes", count(), lru.bytes, order()))
        cams[2].gt()
        cams[1].gt()
        rec.append(("two hits", count(), lru.bytes, order()))
        cams[0].gt()                               # evicted: decodes again
        rec.append(("re-decode", count(), lru.bytes, order()))
        cams[3].gt(cache=False)                    # read through
        rec.append(("read through", count(), lru.bytes, order()))
        assert lru.bytes <= lru.max_bytes
    finally:
        cam_mod.GT_DECODE_CACHE = old
    return rec, packs


def test_lru_and_lazy_gt_match_jax(dataset):
    """``Camera.gt``, ``DecodedLru`` and ``pack_gt_rows`` on lazily stored
    cameras: the same decode counts (a pack decodes only the cameras whose
    rows it packs, once; the LRU serves repeats; a clear costs one
    decode), the same bytes and eviction order under a two-image budget,
    and a read-through that inserts nothing; the packed rows equal."""
    want, j_packs = _lru_sequence(JCAM, JS.Scene, j_pack, dataset)
    got, t_packs = _lru_sequence(TCAM, TS.Scene, t_pack, dataset)
    assert got == want
    for g, w in zip(t_packs, j_packs):
        np.testing.assert_array_equal(g, w)
    assert want[-1][1] == 5 and want[-1][3] == [1, 0]


@pytest.mark.parametrize("mask", ["rank0_of_2", "rank1_of_2", "none"])
def test_scene_decode_mask_matches_jax(dataset, mask):
    """``Scene(decode_mask=)`` stores the cameras the mask keeps, training
    and held-out alike, as JAX's does; every camera's ground truth (stored,
    or decoded on demand through ``gt``) equals JAX's PIL decode."""
    fn = {"rank0_of_2": lambda i, ci: i % 2 == 0,
          "rank1_of_2": lambda i, ci: i % 2 == 1,
          "none": lambda i, ci: False}[mask]
    t = TS.Scene(dataset, eval_split=True, llffhold=HOLD, seed=3,
                 decode_mask=fn)
    j = JS.Scene(dataset, eval_split=True, llffhold=HOLD, seed=3,
                 decode_mask=fn)
    for tc_list, jc_list in ((t.train_cameras, j.train_cameras),
                             (t.test_cameras, j.test_cameras)):
        assert [c.image_name for c in tc_list] == \
            [c.image_name for c in jc_list]
        assert [c.gt_image_u8 is not None for c in tc_list] == \
            [c.gt_image_u8 is not None for c in jc_list]
        assert [c.gt_loader is not None for c in tc_list] == \
            [c.gt_loader is not None for c in jc_list]
        for tc, jc in zip(tc_list, jc_list):
            np.testing.assert_array_equal(tc.gt(cache=False),
                                          jc.gt(cache=False))


def _png_info(path, bg=None):
    return JR.CameraInfo(uid=0, R=np.eye(3), T=np.zeros(3), fovx=1.0,
                         fovy=1.0, image_path=str(path), image_name="im",
                         width=0, height=0, bg=bg)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
def test_decode_png_without_pil(tmp_path, monkeypatch, mode):
    """An 8-bit RGB, RGBA (composited over the background) or grey PNG
    that PIL wrote, with its own row filters, decodes to JAX's PIL
    decode and reads its size with PIL unimportable on the port's side."""
    from PIL import Image

    rng = np.random.default_rng(7)
    chans = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    # smooth gradients plus noise: PIL filters the rows (Sub, Paeth)
    yy, xx = np.mgrid[:37, :53]
    base = (3 * xx + 5 * yy)[..., None] + 40 * np.arange(chans)
    arr = (base + rng.integers(0, 9, base.shape)).astype(np.uint8)
    path = tmp_path / f"im_{mode}.png"
    Image.fromarray(arr[..., 0] if chans == 1 else arr, mode).save(path)
    info = _png_info(path, bg=np.array([1.0, 0.5, 0.0]))
    want = JS.decode_image(info)
    want_size = JR._image_size(str(path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = TS.decode_image(TR.CameraInfo(*info))
    assert TR._image_size(str(path)) == want_size == (53, 37)
    assert got.shape == want.shape == (3, 37, 53)
    np.testing.assert_array_equal(got, want)


def test_jpeg_without_pil_names_the_file(tmp_path, monkeypatch):
    """A JPEG decodes without PIL, to JAX's PIL decode; a truncated JPEG
    raises naming the file, and so does a format that needs PIL when PIL
    is missing (no fallback)."""
    from PIL import Image

    rng = np.random.default_rng(3)
    path = tmp_path / "view.jpg"
    Image.fromarray(rng.integers(0, 255, (19, 27, 3), np.uint8)).save(path)
    want = JS.decode_image(_png_info(path))
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(path.read_bytes()[:300])
    bmp = tmp_path / "view.bmp"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(bmp)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(
        TS.decode_image(TR.CameraInfo(*_png_info(path))), want)
    assert TR._image_size(str(path)) == (27, 19)
    with pytest.raises(ValueError, match="cut.jpg"):
        TS.decode_image(TR.CameraInfo(*_png_info(cut)))
    with pytest.raises(ImportError, match="view.bmp"):
        TS.decode_image(TR.CameraInfo(*_png_info(bmp)))
    with pytest.raises(ImportError, match="view.bmp"):
        TR._image_size(str(bmp))


@pytest.mark.parametrize("local_sampling", [False, True])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_make_decode_mask_matches_jax(monkeypatch, world, local_sampling):
    """The port's mask (one process per device) keeps JAX's cameras for
    every rank, with and without local sampling, and none with storage
    off; with one rank it is None."""
    import jax

    from scripts import train as j_train

    devices = [types.SimpleNamespace(process_index=r) for r in range(world)]
    for storage in (True, False):
        cfg = types.SimpleNamespace(dist=types.SimpleNamespace(
            distributed_dataset_storage=storage,
            local_sampling=local_sampling))
        for rank in range(world):
            monkeypatch.setattr(jax, "process_count", lambda: world)
            monkeypatch.setattr(jax, "process_index", lambda: rank)
            want = j_train.make_decode_mask(cfg, devices)
            got = t_train.make_decode_mask(cfg, world, rank)
            if want is None:
                assert got is None
                continue
            assert [got(i, None) for i in range(23)] == \
                [want(i, None) for i in range(23)] == \
                [i % world == rank for i in range(23)]


def _config(path, threshold, iterations=10, **dist):
    return testing.apply_config(TrainConfig(), dict(
        dist=dict(bsz=2, preload_dataset_to_gpu_threshold=threshold,
                  **dist),
        opt=dict(iterations=iterations), test_iterations=[],
        save_iterations=[], quiet=True, model=dict(model_path=str(path))))


def _l1_history(trainer):
    l1s, real = [], trainer._step

    def step(*args):
        state, m = real(*args)
        l1s.append(float(m["l1"].sum()))
        return state, m

    trainer._step = step
    trainer.train()
    return l1s


def test_one_device_host_path_matches_preloaded(dataset, tmp_path):
    """The one-device loop at threshold 0 on a scene whose every camera is
    lazy (no bank; each step's batch decoded through the LRU and uploaded)
    trains bit-equal to the loop on the fully decoded scene with its
    dataset preloaded; eval reads the lazy held-out views through without
    caching them and gives the same PSNR."""
    eager = TS.Scene(dataset, eval_split=True, llffhold=HOLD)
    lazy = TS.Scene(dataset, eval_split=True, llffhold=HOLD,
                    decode_mask=lambda i, ci: False)
    pre = Trainer(_config(tmp_path / "pre", 10), eager, device="cpu")
    host = Trainer(_config(tmp_path / "host", 0), lazy, device="cpu")
    assert pre._gt_bank is not None and host._gt_bank is None
    n0 = TCAM.LAZY_DECODE_COUNT[0]
    want, got = _l1_history(pre), _l1_history(host)
    assert TCAM.LAZY_DECODE_COUNT[0] > n0
    assert len(got) == 5 and got == want
    assert host.eval_psnr(lazy.test_cameras, 0) == \
        pre.eval_psnr(eager.test_cameras, 0)
    assert all(TCAM.GT_DECODE_CACHE.get(c) is None
               for c in lazy.test_cameras)


def test_two_ranks_storage_host_path_and_preload(dataset, tmp_path):
    """2 gloo ranks of the multi-rank loop with distributed dataset storage
    on (one spawn, ``testing.storage_worker``): each rank decodes only its
    stride at load; at threshold 0 no rank has a bank, some rank decodes
    another's camera on demand for its rows, and the L1 history equals the
    preloaded run's on both ranks. Below the threshold every rank's bank
    holds every training camera's decoded image: the mask applied before
    the preload rule leaves no camera at zero, where the JAX package's
    bank would (its ``_preload_gt`` copies only decoded cameras)."""
    world = 2
    spec = dict(scene_dir=dataset, llffhold=HOLD, config=dict(
        dist=dict(bsz=2), opt=dict(iterations=10), test_iterations=[],
        save_iterations=[], quiet=True))
    path = os.path.join(tmp_path, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    comm.spawn_local(testing.storage_worker,
                     (world, comm.free_port(), path, str(tmp_path)), world,
                     120.0, "the ranks")
    ranks = [np.load(os.path.join(tmp_path, f"rank{r}.npz"))
             for r in range(world)]
    full = JS.Scene(dataset, eval_split=True, llffhold=HOLD)
    n_train = len(full.train_cameras)
    for r, z in enumerate(ranks):
        assert list(z["stored_train"]) == [i % world == r
                                           for i in range(n_train)]
        assert list(z["stored_test"]) == [
            i % world == r for i in range(len(full.test_cameras))]
        assert int(z["load_decodes"]) == 0
        assert not bool(z["host_has_bank"]) and bool(z["preloaded_has_bank"])
        assert len(z["host_l1"]) == 5
        np.testing.assert_array_equal(z["host_l1"], z["preloaded_l1"])
        assert list(z["names"]) == [c.image_name for c in full.train_cameras]
        bank = z["bank"]
        bank = bank.reshape(bank.shape[0], 3, -1, W)[:, :, :H]
        np.testing.assert_array_equal(
            bank, np.stack([c.gt_image_u8 for c in full.train_cameras]))
        assert all(b.any() for b in bank)
    assert sum(int(z["host_decodes"]) for z in ranks) > 0
