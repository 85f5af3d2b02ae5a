"""Camera containers.

Counterpart of grendel_tpu/cameras.py. ``Camera`` is host-side (numpy)
scene metadata; ``CameraArrays`` holds the tensors the render path reads,
one camera or a stacked batch (leading axis = batch). The lazily decoded
ground-truth images of the JAX package belong to training and are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device
from .utils.math3d import perspective_projection, world_to_view


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

    def __post_init__(self):
        self.world_view = world_to_view(self.R, self.T, self.trans, self.scale)
        proj = perspective_projection(self.znear, self.zfar, self.fovx, self.fovy)
        self.full_proj = (proj @ self.world_view).astype(np.float32)
        self.camera_center = np.linalg.inv(self.world_view)[:3, 3].astype(np.float32)

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
