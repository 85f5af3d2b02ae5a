"""Scene container and the epoch-shuffled camera dataset.

The port's own copy of grendel_tpu/data/scene.py (numpy, on the port's
cameras.py). ``Scene`` dispatches on the directory (COLMAP, MatrixCity,
Blender), decodes the ground-truth images at load into (3, H, W) uint8
host arrays, and takes the scene radius as the cameras' extent. With a
``decode_mask`` (distributed dataset storage, scripts/train.py
``make_decode_mask``) a camera the mask refuses is not decoded at load:
it carries a loader, and ``Camera.gt`` decodes it on demand.
``SceneDataset`` draws batches from epoch-wise shuffles with
``random.Random(seed)`` in the JAX package's refill order, so both
packages draw the same camera sequence from the same seed; with local
sampling, ``next_batch_grouped`` draws each rank's group.

Images are read without PIL, which the card's machine lacks: a JPEG by
utils/jpeg.py (native/jpeg_decode.c, bit-equal to PIL's decode), an 8-bit
PNG by utils/png.py; a resize under ``--resolution`` is PIL's bilinear
resize, bit for bit, on the scene's device (ops/resize.py, a kernel on
the card). Only the formats no configuration uses go through PIL.
"""

from __future__ import annotations

import os
import random
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..cameras import Camera
from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.resize import resize_bilinear
from ..utils.jpeg import jpeg_header, read_jpeg
from ..utils.png import png_header, read_png
from .readers import (CameraInfo, SceneInfo, pil_image, read_blender_scene,
                      read_colmap_scene)


def resolve_resolution(orig_w: int, orig_h: int,
                       resolution: float = -1.0) -> tuple:
    """Target (w, h) of the GT decode under ``--resolution``: 1/2/4/8 is an
    integer divider; -1 scales images wider than 1600 px to width 1600;
    any other value is a target width."""
    if resolution in (1, 1.0):
        return orig_w, orig_h
    if resolution in (2, 4, 8, 2.0, 4.0, 8.0):
        d = float(resolution)
    elif resolution == -1:
        d = orig_w / 1600.0 if orig_w > 1600 else 1.0
    else:
        d = orig_w / float(resolution)
    return max(1, int(orig_w / d)), max(1, int(orig_h / d))


def read_image(path: str) -> np.ndarray:
    """(H, W) uint8 of a grey image, (H, W, C) of another, C = 3 or 4 (grey
    with alpha reads as RGBA of its grey), as PIL's ``np.asarray`` gives
    it: an 8-bit PNG through ``read_png``, a JPEG through ``read_jpeg``,
    both without PIL; any other format through PIL, which raises naming
    the file where it is not installed."""
    hdr = png_header(path)
    if hdr is not None and hdr.readable:
        arr = read_png(path)
        if arr.shape[-1] == 2:
            return arr[..., [0, 0, 0, 1]]
        return arr[..., 0] if arr.shape[-1] == 1 else arr
    if hdr is None and jpeg_header(path) is not None:
        return read_jpeg(path)
    Image = pil_image(path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA") if im.mode == "RGBA" else im)


def resize_on(arr: np.ndarray, size: tuple, device) -> np.ndarray:
    """(h, w, C) uint8 of the host image ``arr`` (H, W, C) resized to
    ``size`` = (w, h) with PIL's bilinear filter on ``device``, back on the
    host. On the card the upload, the kernel and the download run on a
    stream of their own, so a decode made inside a training step (a lazily
    stored camera's) waits for its own work, not for the step's queued
    kernels."""
    dev = resolve_device(device)
    img = torch.from_numpy(arr)
    if dev.type != "cuda":
        return resize_bilinear(img.to(dev), size).cpu().numpy()
    with torch.cuda.device(dev), torch.cuda.stream(torch.cuda.Stream(dev)):
        return resize_bilinear(img.to(dev), size).cpu().numpy()


def decode_image(info: CameraInfo, size: Optional[tuple] = None,
                 device=DEFAULT_DEVICE) -> np.ndarray:
    """CameraInfo -> (3, H, W) uint8, alpha composited over ``info.bg``;
    ``size`` = (w, h) resizes at decode, with PIL's bilinear filter, on
    ``device`` (:func:`read_image` reads the file, :func:`resize_on`
    resizes)."""
    arr = read_image(info.image_path)
    if size is not None and size != (arr.shape[1], arr.shape[0]):
        arr = resize_on(arr.reshape(arr.shape[:2] + (-1,)), size, device)
        if arr.shape[-1] == 1:
            arr = arr[..., 0]
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 4:
        rgb = arr[..., :3].astype(np.float32) / 255.0
        alpha = arr[..., 3:4].astype(np.float32) / 255.0
        bg = info.bg if info.bg is not None else np.zeros(3)
        rgb = rgb * alpha + bg * (1.0 - alpha)
        arr = (rgb * 255.0 + 0.5).astype(np.uint8)
    return np.ascontiguousarray(arr[..., :3].transpose(2, 0, 1))


def camera_from_info(uid: int, info: CameraInfo, decode: bool = True,
                     size: Optional[tuple] = None,
                     device=DEFAULT_DEVICE) -> Camera:
    """The camera of ``info``, its ground truth decoded now, or with
    ``decode`` False decoded on demand by ``Camera.gt``; a resize runs on
    ``device``."""
    w, h = size if size is not None else (info.width, info.height)
    return Camera(
        uid=uid, image_name=info.image_name, R=info.R, T=info.T,
        fovx=info.fovx,   # FoV does not change under a uniform rescale
        fovy=info.fovy, width=w, height=h,
        gt_image_u8=decode_image(info, size, device) if decode else None,
        gt_loader=(None if decode
                   else lambda info=info, size=size: decode_image(
                       info, size, device)))


class Scene:
    """Loaded scene: train/test cameras, initial point cloud, extent."""

    def __init__(
        self,
        source_path: str,
        images: str = "images",
        eval_split: bool = False,
        llffhold: int = 8,
        white_background: bool = False,
        num_train: int = -1,
        num_test: int = -1,
        shuffle: bool = True,
        seed: int = 0,
        decode_mask: Optional[Callable[[int, CameraInfo], bool]] = None,
        resolution: float = -1.0,
        decode_workers: int = 8,
        device=DEFAULT_DEVICE,
    ):
        if os.path.exists(os.path.join(source_path, "sparse")):
            info = read_colmap_scene(source_path, images, eval_split,
                                     llffhold, num_train, num_test)
        elif "matrixcity" in source_path.lower():
            from .readers import read_city_scene

            info = read_city_scene(source_path)
        elif os.path.exists(os.path.join(source_path,
                                         "transforms_train.json")):
            info = read_blender_scene(source_path, white_background,
                                      eval_split)
        else:
            raise ValueError(f"unrecognized scene directory: {source_path}")
        self.info: SceneInfo = info
        self.cameras_extent: float = info.nerf_normalization["radius"]
        self.point_cloud = info.point_cloud

        all_infos = list(info.train_cameras) + list(info.test_cameras)
        self.resolution_wh = None
        if all_infos:
            w0, h0 = all_infos[0].width, all_infos[0].height
            self.resolution_wh = resolve_resolution(w0, h0, resolution)

        train_infos = list(info.train_cameras)
        if shuffle:
            # one deterministic shuffle from the seed
            random.Random(seed).shuffle(train_infos)

        def build(infos: Sequence[CameraInfo]) -> List[Camera]:
            # zlib and the C decoders release the interpreter lock, so
            # threads decode in parallel
            from concurrent.futures import ThreadPoolExecutor

            decode = [decode_mask is None or bool(decode_mask(i, ci))
                      for i, ci in enumerate(infos)]
            with ThreadPoolExecutor(max_workers=max(1, decode_workers)) as ex:
                return list(ex.map(
                    lambda t: camera_from_info(t[0], t[1], decode=t[2],
                                               size=self.resolution_wh,
                                               device=device),
                    zip(range(len(infos)), infos, decode)))

        self.train_cameras: List[Camera] = build(train_infos)
        self.test_cameras: List[Camera] = build(info.test_cameras)


class SceneDataset:
    """Epoch-shuffled endless batch sampler over cameras."""

    def __init__(self, cameras: List[Camera], seed: int = 0):
        if not cameras:
            raise ValueError("SceneDataset needs at least one camera")
        self.cameras = cameras
        self.rng = random.Random(seed)
        self._order: List[int] = []
        self._pos = 0
        self.epoch = 0
        self.iteration = 0
        self._groups: list = []       # the streams of next_batch_grouped

    def _refill(self):
        self._order = list(range(len(self.cameras)))
        self.rng.shuffle(self._order)
        self._pos = 0
        self.epoch += 1

    def next_batch(self, bsz: int) -> List[Camera]:
        out = []
        for _ in range(bsz):
            if self._pos >= len(self._order):
                self._refill()
            out.append(self.cameras[self._order[self._pos]])
            self._pos += 1
        self.iteration += bsz
        return out

    def next_batch_grouped(self, bsz: int, n_groups: int) -> List[Camera]:
        """A batch for local sampling: group g holds the cameras with
        ``uid % n_groups == g`` and gives the batch positions
        [g * bsz / n_groups, (g + 1) * bsz / n_groups), from its own
        epoch-shuffled stream; every stream shuffles with the one
        generator, so a seed draws the JAX package's uid sequence."""
        if bsz % n_groups:
            raise ValueError(f"local sampling needs bsz divisible by the "
                             f"device count (bsz {bsz}, {n_groups} devices)")
        if len(self._groups) != n_groups:
            self._groups = [
                {"idx": [i for i, c in enumerate(self.cameras)
                         if c.uid % n_groups == g], "order": [], "pos": 0}
                for g in range(n_groups)]
            if not all(s["idx"] for s in self._groups):
                raise ValueError(f"a group of the {n_groups} devices has no "
                                 f"camera")
        out = []
        for s in self._groups:
            for _ in range(bsz // n_groups):
                if s["pos"] >= len(s["order"]):
                    s["order"] = list(s["idx"])
                    self.rng.shuffle(s["order"])
                    s["pos"] = 0
                out.append(self.cameras[s["order"][s["pos"]]])
                s["pos"] += 1
        self.iteration += bsz
        return out

    @property
    def epoch_len(self) -> int:
        return len(self.cameras)
