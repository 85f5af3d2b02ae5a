"""Camera containers.

Counterpart of grendel_tpu/cameras.py. ``Camera`` is host-side (numpy)
scene metadata; ``CameraArrays`` holds the tensors the render path reads,
one camera or a stacked batch (leading axis = batch).

A camera's ground truth is a (3, H, W) uint8 host array: decoded at load
(``gt_image_u8``), or, for a camera this process does not store under
``--distributed_dataset_storage``, decoded on demand by ``gt_loader``
through the byte-budgeted ``GT_DECODE_CACHE``. :meth:`Camera.gt` reads
either; ``LAZY_DECODE_COUNT`` counts the on-demand decodes.
"""

from __future__ import annotations

import dataclasses
import os
import weakref
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device
from .utils.math3d import perspective_projection, world_to_view

# on-demand GT decodes over every camera of the process: a process that
# stores only its stride of the dataset decodes the rest lazily
LAZY_DECODE_COUNT = [0]


class DecodedLru:
    """Byte-budgeted LRU of lazily decoded GT images.

    The budget (``GRENDEL_GT_CACHE_BYTES``, 1 GiB by default), not an item
    count, bounds host memory at any image size; within an epoch each
    camera decodes once while the working set fits. Entries hold their
    camera weakly, and one finalizer per camera drops its entry when the
    camera is collected, so a discarded scene pins no decoded images."""

    def __init__(self, max_bytes: Optional[int] = None):
        if max_bytes is None:
            max_bytes = int(os.environ.get("GRENDEL_GT_CACHE_BYTES",
                                           1 << 30))
        self.max_bytes = max_bytes
        self.bytes = 0
        # id(cam) -> (weakref(cam), img); the weakref keeps id(cam)
        # unambiguous while the entry lives
        self._entries: OrderedDict = OrderedDict()
        # cameras with a finalizer: one per camera, not per insert, so
        # eviction and re-decode cycles do not pile finalizers up
        self._finalized: set = set()

    def get(self, cam) -> Optional[np.ndarray]:
        k = id(cam)
        hit = self._entries.get(k)
        if hit is None:
            return None
        self._entries.move_to_end(k)
        return hit[1]

    def _on_camera_dead(self, k: int):
        self._finalized.discard(k)      # the id may go to a new camera
        hit = self._entries.pop(k, None)
        if hit is not None:
            self.bytes -= hit[1].nbytes

    def put(self, cam, img: np.ndarray):
        if img.nbytes > self.max_bytes:
            return
        k = id(cam)
        if k in self._entries:
            self.bytes -= self._entries[k][1].nbytes
            ref = self._entries[k][0]
        else:
            ref = weakref.ref(cam)
            if k not in self._finalized:
                self._finalized.add(k)
                weakref.finalize(cam, self._on_camera_dead, k)
        self._entries[k] = (ref, img)
        self._entries.move_to_end(k)
        self.bytes += img.nbytes
        while self.bytes > self.max_bytes and self._entries:
            _, (_, old) = self._entries.popitem(last=False)
            self.bytes -= old.nbytes

    def clear(self):
        self._entries.clear()
        self.bytes = 0


GT_DECODE_CACHE = DecodedLru()


@dataclasses.dataclass
class Camera:
    uid: int
    image_name: str
    R: np.ndarray          # (3,3) camera-to-world rotation (COLMAP qvec2rotmat().T)
    T: np.ndarray          # (3,) world-to-camera translation
    fovx: float
    fovy: float
    width: int
    height: int
    gt_image_u8: Optional[np.ndarray] = None   # (3,H,W) uint8, host
    znear: float = 0.01
    zfar: float = 100.0
    trans: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0
    # a camera this process does not store keeps gt_image_u8 None and
    # decodes on demand with this (distributed dataset storage)
    gt_loader: Optional[Callable[[], np.ndarray]] = None

    def __post_init__(self):
        self.world_view = world_to_view(self.R, self.T, self.trans, self.scale)
        proj = perspective_projection(self.znear, self.zfar, self.fovx, self.fovy)
        self.full_proj = (proj @ self.world_view).astype(np.float32)
        self.camera_center = np.linalg.inv(self.world_view)[:3, 3].astype(np.float32)

    def gt(self, cache: bool = True) -> Optional[np.ndarray]:
        """The ground truth: the stored image, else a decode through
        ``GT_DECODE_CACHE`` (``LAZY_DECODE_COUNT`` advances once per miss).
        ``cache=False`` reads through without inserting on a miss, so a
        sweep over every camera (eval) does not evict the training
        working set."""
        if self.gt_image_u8 is not None:
            return self.gt_image_u8
        if self.gt_loader is None:
            return None
        img = GT_DECODE_CACHE.get(self)
        if img is None:
            LAZY_DECODE_COUNT[0] += 1
            img = self.gt_loader()
            if cache:
                GT_DECODE_CACHE.put(self, img)
        return img

    @property
    def tanfovx(self) -> float:
        return float(np.tan(self.fovx * 0.5))

    @property
    def tanfovy(self) -> float:
        return float(np.tan(self.fovy * 0.5))


class CameraArrays(NamedTuple):
    """Camera tensors; every leaf gains a leading (B,) axis when batched."""

    viewmat: torch.Tensor      # (4,4) or (B,4,4)
    full_proj: torch.Tensor    # (4,4) or (B,4,4)
    campos: torch.Tensor       # (3,)  or (B,3)
    tanfov: torch.Tensor       # (2,)  or (B,2)  [tanfovx, tanfovy]


def camera_arrays(cam: Camera, device=DEFAULT_DEVICE) -> CameraArrays:
    return CameraArrays(*(x[0] for x in batch_camera_arrays([cam], device)))


def batch_camera_arrays(cams: list[Camera], device=DEFAULT_DEVICE) -> CameraArrays:
    """Stack host cameras into a batched CameraArrays (B leading axis)."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return CameraArrays(
        viewmat=t(np.stack([c.world_view for c in cams])),
        full_proj=t(np.stack([c.full_proj for c in cams])),
        campos=t(np.stack([c.camera_center for c in cams])),
        tanfov=t([[c.tanfovx, c.tanfovy] for c in cams]),
    )
