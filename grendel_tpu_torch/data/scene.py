"""Scene container and the epoch-shuffled camera dataset.

The port's own copy of grendel_tpu/data/scene.py (numpy, on the port's
cameras.py). ``Scene`` dispatches on the directory (COLMAP, MatrixCity,
Blender), decodes every ground-truth image once at load into a (3, H, W)
uint8 host array, and takes the scene radius as the cameras' extent.
``SceneDataset`` draws batches from epoch-wise shuffles with
``random.Random(seed)`` in the JAX package's refill order, so both
packages draw the same camera sequence from the same seed.

Left for the multi-GPU slice: the per-host ``decode_mask`` of the JAX
package's distributed dataset storage and ``next_batch_grouped`` of its
local sampling. PIL is imported inside :func:`decode_image`.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Sequence

import numpy as np

from ..cameras import Camera
from .readers import (CameraInfo, SceneInfo, read_blender_scene,
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


def decode_image(info: CameraInfo, size: Optional[tuple] = None) -> np.ndarray:
    """CameraInfo -> (3, H, W) uint8, alpha composited over ``info.bg``;
    ``size`` = (w, h) resizes at decode."""
    from PIL import Image

    with Image.open(info.image_path) as im:
        if size is not None and size != (im.width, im.height):
            im = im.resize(size, Image.BILINEAR)
        arr = np.asarray(im.convert("RGBA") if im.mode == "RGBA" else im)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 4:
        rgb = arr[..., :3].astype(np.float32) / 255.0
        alpha = arr[..., 3:4].astype(np.float32) / 255.0
        bg = info.bg if info.bg is not None else np.zeros(3)
        rgb = rgb * alpha + bg * (1.0 - alpha)
        arr = (rgb * 255.0 + 0.5).astype(np.uint8)
    return np.ascontiguousarray(arr[..., :3].transpose(2, 0, 1))


def camera_from_info(uid: int, info: CameraInfo,
                     size: Optional[tuple] = None) -> Camera:
    w, h = size if size is not None else (info.width, info.height)
    return Camera(
        uid=uid, image_name=info.image_name, R=info.R, T=info.T,
        fovx=info.fovx,   # FoV does not change under a uniform rescale
        fovy=info.fovy, width=w, height=h,
        gt_image_u8=decode_image(info, size=size))


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
        resolution: float = -1.0,
        decode_workers: int = 8,
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
            # PIL releases the interpreter lock while it decompresses, so
            # threads decode in parallel
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=max(1, decode_workers)) as ex:
                return list(ex.map(
                    lambda t: camera_from_info(t[0], t[1],
                                               size=self.resolution_wh),
                    enumerate(infos)))

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

    @property
    def epoch_len(self) -> int:
        return len(self.cameras)
