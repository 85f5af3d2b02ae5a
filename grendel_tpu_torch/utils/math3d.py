"""Camera and rigid-body math for 3D Gaussian Splatting.

Counterpart of grendel_tpu/utils/math3d.py: the standard 3DGS camera model
(world-to-view + OpenGL-style perspective projection, EWA splatting
conventions). Tensor functions are plain differentiable torch; the camera
matrices are host-side numpy, as cameras are static per scene.

Conventions:
  * Matrices act on column vectors: ``p_view = view @ [p; 1]``.
  * ``R`` passed to :func:`world_to_view` is the camera-to-world rotation
    (COLMAP ``qvec2rotmat(qvec).T``), ``t`` is the world-to-camera
    translation.
  * NDC-to-pixel uses the 3DGS convention ``((ndc + 1) * size - 1) / 2``.
"""

from __future__ import annotations

import numpy as np
import torch


def _normalized(q: torch.Tensor) -> torch.Tensor:
    return q / (torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)) + 1e-12)


def quat_rotmat_entries(q: torch.Tensor):
    """Rotation-matrix entries of quaternion(s) (..., 4) [w, x, y, z] as
    nine (...,) tensors, row-major. Normalizes the input."""
    q = _normalized(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (..., 4) [w, x, y, z] -> rotation matrix (..., 3, 3)."""
    r = quat_rotmat_entries(q)
    return torch.stack([torch.stack(r[0:3], -1), torch.stack(r[3:6], -1),
                        torch.stack(r[6:9], -1)], -2)


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """4x4 world->camera matrix from COLMAP-style (R=c2w rotation, t=w2c
    translation); ``translate``/``scale`` recentre the camera positions."""
    if translate is None:
        translate = np.zeros(3)
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    c2w[:3, 3] = (c2w[:3, 3] + translate) * scale
    return np.linalg.inv(c2w).astype(np.float32)


def perspective_projection(znear: float, zfar: float,
                           fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style projection matrix of the 3DGS renderer: view-space z in
    [znear, zfar] maps to [0, 1] after the perspective divide."""
    top = float(np.tan(fovy / 2)) * znear
    bottom = -top
    right = float(np.tan(fovx / 2)) * znear
    left = -right
    P = np.zeros((4, 4), dtype=np.float32)
    z_sign = 1.0
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = z_sign
    P[2, 2] = z_sign * zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov_to_focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * np.tan(fov / 2.0))


def focal_to_fov(focal: float, pixels: float) -> float:
    return 2.0 * float(np.arctan(pixels / (2.0 * focal)))


def ndc_to_pixel(v, size: int):
    """3DGS NDC [-1, 1] -> pixel-center coordinate."""
    return ((v + 1.0) * size - 1.0) * 0.5


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))
