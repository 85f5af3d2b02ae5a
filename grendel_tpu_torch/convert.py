"""Carry model and training state from numpy (e.g. the JAX package's) into
the port.

:func:`params_from_numpy` takes the six ``GaussianParams`` fields as numpy
arrays, named as in both packages, so a model held by ``grendel_tpu``
(``{k: np.asarray(v) for k, v in params._asdict().items()}``) renders in
the port on the same values. :func:`train_state_from_numpy` carries a whole
training state the same way (parameters, Adam moments and count, densify
statistics, iteration), so both packages can continue one mid-training
state. :func:`scene_from_numpy` carries a scene (cameras, ground truth,
point cloud, extent), so both packages can train on the same one;
:func:`scene_arrays` takes either package's scene to arrays and
:func:`scene_from_arrays` back (to hand a scene to spawned ranks through
an npz). A model
on disk crosses through its PLY instead (engine/gaussian_io.py), a
training state through its checkpoint (engine/checkpoint.py).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device
from .models.gaussian_model import GaussianParams


def params_from_numpy(fields: dict, alive, device=DEFAULT_DEVICE):
    """(GaussianParams of float32 tensors, bool alive mask) on ``device``."""
    dev = resolve_device(device)
    missing = set(GaussianParams._fields) - set(fields)
    if missing:
        raise ValueError(f"missing GaussianParams fields: {sorted(missing)}")
    params = GaussianParams(**{
        k: torch.tensor(np.asarray(fields[k], np.float32), device=dev)
        for k in GaussianParams._fields})
    n = params.means3d.shape[0]
    if any(p.shape[0] != n for p in params):
        raise ValueError("all fields must share the capacity axis")
    alive_t = torch.tensor(np.asarray(alive, bool), device=dev)
    if alive_t.shape != (n,):
        raise ValueError(f"alive must be ({n},), got {tuple(alive_t.shape)}")
    return params, alive_t


def train_state_from_numpy(params: dict, alive, adam_mu: dict, adam_nu: dict,
                           adam_count, stats: dict, iteration,
                           device=DEFAULT_DEVICE):
    """The port's ``TrainState`` from the leaves of a ``TrainState`` as
    numpy: ``params``, ``adam_mu`` and ``adam_nu`` hold the six
    ``GaussianParams`` fields, ``stats`` the three ``DensifyStats`` fields
    (``grad_accum``, ``denom``, ``max_radii``); ``adam_count`` and
    ``iteration`` are int scalars."""
    from .engine.train import TrainState
    from .models.densify import DensifyStats
    from .models.optimizer import AdamState

    dev = resolve_device(device)
    p, alive_t = params_from_numpy(params, alive, dev)
    mu, _ = params_from_numpy(adam_mu, alive, dev)
    nu, _ = params_from_numpy(adam_nu, alive, dev)
    for name, moment in (("adam_mu", mu), ("adam_nu", nu)):
        if any(a.shape != b.shape for a, b in zip(moment, p)):
            raise ValueError(f"{name} must have the shapes of params")
    missing = set(DensifyStats._fields) - set(stats)
    if missing:
        raise ValueError(f"missing DensifyStats fields: {sorted(missing)}")
    st = DensifyStats(**{
        k: torch.tensor(np.asarray(stats[k], np.float32), device=dev)
        for k in DensifyStats._fields})
    if any(x.shape != alive_t.shape for x in st):
        raise ValueError("densify stats must be (N,)")

    def i32(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=dev)

    return TrainState(params=p, alive=alive_t,
                      adam=AdamState(mu=mu, nu=nu, count=i32(adam_count)),
                      stats=st, iteration=i32(iteration))


class NumpyScene(NamedTuple):
    """A scene in ``Scene``'s duck type, as the trainer reads it."""

    train_cameras: List
    test_cameras: List
    cameras_extent: float
    point_cloud: object        # data.readers.PointCloud


def cameras_from_numpy(cams: dict) -> list:
    """Port cameras from arrays: ``cams`` holds ``world_view`` (C, 4, 4),
    ``full_proj`` (C, 4, 4), ``camera_center`` (C, 3), ``tanfov`` (C, 2),
    ``uid`` (C,) and ``gt_u8`` (C, 3, H, W) uint8, which also gives the
    image size. The matrices are kept as given, so a camera projects
    exactly as the package that made them."""
    from .cameras import Camera

    out = []
    gt = np.asarray(cams["gt_u8"], np.uint8)
    for i in range(gt.shape[0]):
        wv = np.asarray(cams["world_view"][i], np.float32)
        tx, ty = (float(v) for v in cams["tanfov"][i])
        cam = Camera(uid=int(cams["uid"][i]), image_name=f"view_{i:03d}",
                     R=wv[:3, :3].T.astype(np.float64),
                     T=wv[:3, 3].astype(np.float64),
                     fovx=2.0 * float(np.arctan(tx)),
                     fovy=2.0 * float(np.arctan(ty)),
                     width=gt.shape[3], height=gt.shape[2],
                     gt_image_u8=gt[i])
        cam.world_view = wv
        cam.full_proj = np.asarray(cams["full_proj"][i], np.float32)
        cam.camera_center = np.asarray(cams["camera_center"][i], np.float32)
        out.append(cam)
    return out


def scene_from_numpy(train: dict, test: dict, points, colors,
                     extent: float) -> NumpyScene:
    """A scene from arrays: ``train`` and ``test`` cameras as
    :func:`cameras_from_numpy` takes them (``test`` may be empty), the
    initial point cloud ``points`` (M, 3) and ``colors`` (M, 3) in [0, 1],
    and the cameras' ``extent``."""
    from .data.readers import PointCloud

    return NumpyScene(
        train_cameras=cameras_from_numpy(train),
        test_cameras=cameras_from_numpy(test) if test else [],
        cameras_extent=float(extent),
        point_cloud=PointCloud(points=np.asarray(points, np.float32),
                               colors=np.asarray(colors, np.float32)))


def cameras_to_numpy(cameras) -> dict:
    """The inverse of :func:`cameras_from_numpy`: the arrays it takes, of
    either package's cameras (both have the same fields and ``gt()``)."""
    return dict(
        world_view=np.stack([c.world_view for c in cameras]),
        full_proj=np.stack([c.full_proj for c in cameras]),
        camera_center=np.stack([c.camera_center for c in cameras]),
        tanfov=np.array([[c.tanfovx, c.tanfovy] for c in cameras],
                        np.float32),
        uid=np.array([c.uid for c in cameras], np.int64),
        gt_u8=np.stack([c.gt(cache=False) for c in cameras]))


def scene_arrays(scene) -> dict:
    """Either package's scene as one flat dict of numpy arrays (an npz's
    contents, to hand it to spawned ranks): ``train_<key>`` and
    ``test_<key>`` for :func:`cameras_to_numpy`'s arrays, ``points``,
    ``colors`` and ``extent``. :func:`scene_from_arrays` reads it back."""
    out = {}
    for prefix, cameras in (("train_", scene.train_cameras),
                            ("test_", scene.test_cameras)):
        if cameras:
            out.update({prefix + k: v for k, v in
                        cameras_to_numpy(cameras).items()})
    pcd = scene.point_cloud
    return dict(out, points=np.asarray(pcd.points, np.float32),
                colors=np.asarray(pcd.colors, np.float32),
                extent=np.float64(scene.cameras_extent))


def scene_from_arrays(arrays) -> NumpyScene:
    """The scene of :func:`scene_arrays`'s dict, or of an npz of it (keys
    other than the scene's are ignored)."""
    def cams(prefix):
        return {k[len(prefix):]: arrays[k] for k in arrays.keys()
                if k.startswith(prefix)}

    return scene_from_numpy(cams("train_"), cams("test_"), arrays["points"],
                            arrays["colors"], float(arrays["extent"]))
