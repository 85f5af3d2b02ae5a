"""Scenes drawn from a run's seed: cameras, Gaussians, ground truth, and
the truck dataset on disk.

Frozen copies of the program's scene generators, so that a change to the
program cannot change what is measured:

  * orbit cameras as the garden benchmark places them (the program's
    ``testing.make_test_camera``: a circle of radius ``dist`` in the
    xz-plane, looking at the origin, fovx 1.0);
  * random Gaussians in the garden benchmark's distribution
    (``testing.random_gaussians``, ``params_fields``), drawn on the device
    by one ``torch.Generator`` in a few large calls;
  * the structured scene's camera rig (``testing.StructuredSyntheticScene``,
    ``lookat_camera``: three rings of a hemisphere, fovx 1.1), its
    point cloud's surfaces (a ground disk and eight spheres), and a COLMAP
    writer (``scripts/export_structured_dataset.py write_colmap``,
    ``data/colmap.py``).

The camera matrices follow 3DGS (``utils/math3d.py``): world-to-view from
the camera-to-world rotation and the world-to-camera translation, an
OpenGL-style projection with znear 0.01 and zfar 100.
"""

from __future__ import annotations

import os
import struct
from typing import List, NamedTuple

import numpy as np
import torch

from .reference.render import Camera

ZNEAR, ZFAR = 0.01, 100.0
SH_C0 = 0.28209479177387814


class HostCamera(NamedTuple):
    """A camera as a COLMAP dataset stores it."""

    name: str
    R: np.ndarray        # camera-to-world rotation
    T: np.ndarray        # world-to-camera translation
    fovx: float
    fovy: float
    width: int
    height: int


def matrices(cam: HostCamera):
    """(world-to-view, full projection, centre, (tan fovx/2, tan fovy/2))
    as float32 numpy, the 3DGS conventions."""
    rt = np.zeros((4, 4))
    rt[:3, :3] = cam.R.T
    rt[:3, 3] = cam.T
    rt[3, 3] = 1.0
    view = np.linalg.inv(np.linalg.inv(rt)).astype(np.float32)
    top = np.tan(cam.fovy / 2) * ZNEAR
    right = np.tan(cam.fovx / 2) * ZNEAR
    p = np.zeros((4, 4), np.float32)
    p[0, 0] = 2 * ZNEAR / (2 * right)
    p[1, 1] = 2 * ZNEAR / (2 * top)
    p[3, 2] = 1.0
    p[2, 2] = ZFAR / (ZFAR - ZNEAR)
    p[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    full = (p @ view).astype(np.float32)
    centre = np.linalg.inv(view)[:3, 3].astype(np.float32)
    tan = np.array([np.tan(cam.fovx / 2), np.tan(cam.fovy / 2)], np.float32)
    return view, full, centre, tan


def device_camera(cam: HostCamera, device) -> Camera:
    return Camera(*(torch.as_tensor(x, device=device) for x in matrices(cam)))


def orbit_camera(width: int, height: int, dist: float, angle: float,
                 fovx: float = 1.0) -> HostCamera:
    ca, sa = np.cos(angle), np.sin(angle)
    r_w2c = np.array([[ca, 0, -sa], [0, 1, 0], [sa, 0, ca]])
    fovy = 2 * np.arctan(np.tan(fovx / 2) * height / width)
    return HostCamera(f"orbit_{angle:.6f}", r_w2c.T, np.array([0, 0, dist]),
                      fovx, float(fovy), width, height)


def orbit_angles(n: int, gen: torch.Generator) -> List[float]:
    """``n`` evenly spaced azimuths, the whole ring turned and shuffled by
    the seed: every seed renders the same kind of views, in its own
    order."""
    phase = float(torch.rand((), generator=gen, device=gen.device))
    perm = torch.randperm(n, generator=gen, device=gen.device).tolist()
    return [2 * np.pi * (phase + k) / n for k in perm]


def garden_gaussians(n_live: int, capacity: int, extent: float,
                     log_scale: tuple, opacity: tuple, sh_degree: int,
                     gen: torch.Generator):
    """Raw parameters (dict of the six leaves) and the alive mask: the
    garden benchmark's random Gaussians in the first ``n_live`` of
    ``capacity`` slots; dead slots hold log-scale and logit-opacity -10
    and the identity rotation."""
    dev = gen.device
    k = (sh_degree + 1) ** 2

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    means = u((n_live, 3), -extent, extent)
    scales = u((n_live, 3), *log_scale)
    quats = torch.randn((n_live, 4), generator=gen, device=dev)
    op = u((n_live,), *opacity).clamp(1e-4, 1 - 1e-4)
    dc = (u((n_live, 1, 3), 0.1, 0.9) - 0.5) / SH_C0
    rest = 0.05 * torch.randn((n_live, k - 1, 3), generator=gen, device=dev)
    pad = capacity - n_live

    def padded(x, fill=0.0):
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill,
                                        device=dev)])

    q = padded(quats)
    q[n_live:, 0] = 1.0
    params = {"means3d": padded(means), "sh_dc": padded(dc),
              "sh_rest": padded(rest), "scales_raw": padded(scales, -10.0),
              "quats": q,
              "opacities_raw": padded(torch.log(op / (1 - op)), -10.0)}
    alive = torch.arange(capacity, device=dev) < n_live
    return params, alive


def random_images(n: int, h: int, w: int, gen: torch.Generator):
    """(n, 3, h, w) uint8 ground truth, uniform in [0, 255)."""
    return torch.randint(0, 255, (n, 3, h, w), generator=gen,
                         device=gen.device, dtype=torch.uint8)


# --- the structured scene's rig and surfaces ----------------------------

TARGET = np.array([0.0, 0.42, 0.0])
RINGS = ((4.4, 21.0, 0.5), (3.8, 38.0, 0.333), (3.1, 56.0, 0.167))
GROUND_Y = 0.8
SPHERES = (((0.00, 0.00), 0.52), ((1.15, 0.55), 0.38), ((-1.05, 0.50), 0.33),
           ((0.65, -0.95), 0.25), ((-0.70, -0.80), 0.22), ((0.10, 1.25), 0.18),
           ((-1.50, -0.35), 0.15), ((1.60, -0.45), 0.12))


def lookat(pos, width: int, height: int, fovx: float, name: str):
    f = TARGET - pos
    f = f / np.linalg.norm(f)
    r = np.cross([0.0, 1.0, 0.0], f)
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)
    r_w2c = np.stack([r, d, f])
    fovy = 2 * np.arctan(np.tan(fovx / 2) * height / width)
    return HostCamera(name, r_w2c.T, -r_w2c @ pos, fovx, float(fovy), width,
                      height)


def structured_rig(n_cams: int, width: int, height: int,
                   fovx: float = 1.1) -> List[HostCamera]:
    """The structured scene's cameras in azimuth order, named view_000..."""
    counts = [max(3, int(round(n_cams * s))) for _, _, s in RINGS]
    counts[0] += n_cams - sum(counts)
    poses = []
    for k, ((dist, elev, _), cnt) in enumerate(zip(RINGS, counts)):
        e = np.deg2rad(elev)
        for i in range(cnt):
            az = 2 * np.pi * ((i / cnt + k * 0.37) % 1.0)
            poses.append((az, TARGET + np.array([
                dist * np.cos(e) * np.cos(az), -dist * np.sin(e),
                dist * np.cos(e) * np.sin(az)])))
    poses.sort(key=lambda t: t[0])
    return [lookat(pos, width, height, fovx, f"view_{i:03d}")
            for i, (_, pos) in enumerate(poses)]


def structured_points(n: int, seed: int):
    """(points (n', 3), colours (n', 3)) on the structured scene's surfaces,
    denser toward the disk's centre, with 1 cm of noise; colours uniform in
    [0.1, 0.9]. Drawn from ``seed`` on the host."""
    rng = np.random.default_rng(seed)
    areas = np.array([4 * np.pi * r * r for _, r in SPHERES])
    w_all = np.concatenate([[np.pi * 3.6 ** 2], areas])
    counts = (n * w_all / w_all.sum()).astype(int)
    rad = 3.6 * np.sqrt(rng.random(counts[0])) * (
        0.55 + 0.45 * rng.random(counts[0]))
    az = 2 * np.pi * rng.random(counts[0])
    pts = [np.stack([rad * np.cos(az), np.full(counts[0], GROUND_Y),
                     rad * np.sin(az)], -1)]
    for ((cx, cz), r), m in zip(SPHERES, counts[1:]):
        u = rng.normal(size=(max(m, 8), 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        pts.append(np.array([cx, GROUND_Y - r, cz]) + r * u)
    pts = np.concatenate(pts)
    pts = pts + rng.normal(scale=0.01, size=pts.shape)
    cols = rng.uniform(0.1, 0.9, pts.shape)
    return pts.astype(np.float32), cols.astype(np.float32)


def camera_extent(cams: List[HostCamera]) -> float:
    """3DGS's scene radius: 1.1 x the largest distance of a camera centre
    from their mean."""
    c = np.stack([matrices(k)[2] for k in cams]).astype(np.float64)
    return float(np.linalg.norm(c - c.mean(0), axis=-1).max() * 1.1)


def knn_log_scales(points: torch.Tensor, k: int = 3, rows: int = 4096):
    """3DGS's initial log-scale of each point: log sqrt of the mean squared
    distance to its ``k`` nearest other points (at least 1e-7)."""
    out = []
    for i in range(0, points.shape[0], rows):
        d = torch.cdist(points[i:i + rows].double(), points.double())
        d2 = d.pow(2)
        idx = torch.arange(i, min(i + rows, points.shape[0]),
                           device=points.device)
        d2[torch.arange(idx.numel(), device=points.device), idx] = float("inf")
        near = torch.topk(d2, k, largest=False).values.mean(1)
        out.append(near.clamp(min=1e-7))
    return (0.5 * torch.log(torch.cat(out))).float()


def _rotmat_to_qvec(m):
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
        q = np.empty(4)
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
    return q if q[0] >= 0 else -q


def write_colmap(out: str, cams: List[HostCamera], points, colors,
                 suffix: str = ".jpg") -> None:
    """``out/sparse/0/{cameras,images,points3D}.bin``: one PINHOLE camera
    (that of the first view), the views, and the point cloud."""
    sparse = os.path.join(out, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    c0 = cams[0]
    fx = c0.width / (2 * np.tan(c0.fovx / 2))
    fy = c0.height / (2 * np.tan(c0.fovy / 2))
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, c0.width, c0.height))
        f.write(struct.pack("<4d", fx, fy, c0.width / 2, c0.height / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for i, c in enumerate(cams):
            f.write(struct.pack("<idddddddi", i + 1, *_rotmat_to_qvec(c.R.T),
                                *np.asarray(c.T, np.float64), 1))
            f.write(f"{c.name}{suffix}".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    rec = np.zeros(len(points), dtype=np.dtype([
        ("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("err", "<f8"),
        ("track", "<u8")]))
    rec["id"] = np.arange(len(points))
    rec["xyz"] = points
    rec["rgb"] = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        f.write(rec.tobytes())
