"""Scene readers: COLMAP reconstructions, Blender (NeRF-synthetic) and
MatrixCity sets.

The port's own copy of grendel_tpu/data/readers.py (numpy, on the port's
utils/math3d.py and utils/ply.py): FoV from the intrinsics, the
train/test split by llffhold, the point cloud from points3D, white or
black background compositing for Blender sets, and the scene radius of
1.1 x the largest camera distance from the mean camera center. Where a
file gives no colors or no points, the random fill comes from
``np.random.default_rng(0)``. The size of a PNG comes from its header
(utils/png.py), a JPEG's from its frame header (utils/jpeg.py), with no
PIL; other formats are opened with PIL, imported inside
:func:`pil_image`, which names the file when PIL is missing.
"""

from __future__ import annotations

import json
import os
from typing import List, NamedTuple, Optional

import numpy as np

from . import colmap
from ..utils.jpeg import jpeg_header
from ..utils.math3d import focal_to_fov, fov_to_focal, world_to_view
from ..utils.ply import read_ply, write_ply
from ..utils.png import png_header


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray          # (3,3) cam-to-world rotation (qvec2rotmat(q).T)
    T: np.ndarray          # (3,) world-to-cam translation
    fovx: float
    fovy: float
    image_path: str
    image_name: str
    width: int
    height: int
    # Blender only: composite alpha over this background at decode time.
    bg: Optional[np.ndarray] = None


class PointCloud(NamedTuple):
    points: np.ndarray   # (M, 3)
    colors: np.ndarray   # (M, 3) in [0, 1]


class SceneInfo(NamedTuple):
    point_cloud: PointCloud
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    """Scene translate/radius from camera centers (ref: getNerfppNorm)."""
    centers = []
    for cam in cam_infos:
        w2c = world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers, axis=1)       # (3, n)
    avg = centers.mean(axis=1, keepdims=True)
    diagonal = float(np.max(np.linalg.norm(centers - avg, axis=0)))
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}


def pil_image(path: str):
    """PIL's ``Image`` module, to read ``path``; raises, naming the file,
    where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading this image needs PIL, which is "
                          f"not installed (JPEGs and 8-bit PNGs are read "
                          f"without it)") from e
    return Image


def _image_size(path: str):
    """(w, h) of an image: a PNG's from its header, a JPEG's from its
    frame header, another format's through PIL."""
    hdr = png_header(path) or jpeg_header(path)
    if hdr is not None:
        return hdr.width, hdr.height
    with pil_image(path).open(path) as im:
        return im.size


def read_colmap_scene(
    source_path: str,
    images: str = "images",
    eval_split: bool = False,
    llffhold: int = 8,
    num_train: int = -1,
    num_test: int = -1,
) -> SceneInfo:
    """Load a COLMAP scene directory (sparse/0 + image folder)."""
    sparse = os.path.join(source_path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(source_path, "sparse")
    try:
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    images_folder = os.path.join(source_path, images)
    cam_infos = []
    # sort by image name for deterministic ordering (matches reference's
    # sorted(..., key=lambda x: x.image_name))
    for img in sorted(extr.values(), key=lambda im: im.name):
        cam = intr[img.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
        elif cam.model in ("PINHOLE", "OPENCV"):
            fx, fy = cam.params[0], cam.params[1]
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {cam.model}; undistort first"
            )
        fovy = focal_to_fov(fy, cam.height)
        fovx = focal_to_fov(fx, cam.width)
        image_path = os.path.join(images_folder, os.path.basename(img.name))
        # actual (possibly pre-downscaled) image size
        w, h = _image_size(image_path)
        cam_infos.append(CameraInfo(
            uid=cam.id,
            R=colmap.qvec_to_rotmat(img.qvec).T,
            T=np.array(img.tvec),
            fovx=fovx, fovy=fovy,
            image_path=image_path,
            image_name=os.path.basename(image_path).split(".")[0],
            width=w, height=h,
        ))

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []
    if num_train > 0:
        train = train[:num_train]
    if num_test > 0:
        test = test[:num_test]

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(
                os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3d_text(
                os.path.join(sparse, "points3D.txt"))
        write_ply(ply_path, {
            "x": xyz[:, 0].astype(np.float32),
            "y": xyz[:, 1].astype(np.float32),
            "z": xyz[:, 2].astype(np.float32),
            "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2],
        })
    pcd = _fetch_ply(ply_path)

    return SceneInfo(
        point_cloud=pcd,
        train_cameras=train,
        test_cameras=test,
        nerf_normalization=nerfpp_norm(train),
        ply_path=ply_path,
    )


def _fetch_ply(path: str) -> PointCloud:
    fields = read_ply(path)
    pts = np.stack([fields["x"], fields["y"], fields["z"]], axis=-1).astype(np.float32)
    if "red" in fields:
        cols = np.stack(
            [fields["red"], fields["green"], fields["blue"]], axis=-1
        ).astype(np.float32) / 255.0
    else:
        cols = np.random.default_rng(0).random(
            (pts.shape[0], 3)).astype(np.float32)
    return PointCloud(points=pts, colors=cols)


def read_city_scene(
    source_path: str,
    extension: str = ".tif",
) -> SceneInfo:
    """MatrixCity reader (ref: readCityInfo, dataset_readers.py:456-507):
    transforms_{train,test}.json with either a global camera_angle_x or
    per-frame fl_x/fl_y pixel focals; point cloud from the first .ply in
    the scene directory (tiepoints are required)."""
    import glob as _glob

    def read_split(transforms_file: str, uid0: int) -> List[CameraInfo]:
        with open(os.path.join(source_path, transforms_file)) as f:
            meta = json.load(f)
        fovx_global = meta.get("camera_angle_x")
        infos = []
        for i, frame in enumerate(meta["frames"]):
            name = frame["file_path"]
            ext = "" if name.split(".")[-1].lower() in ("jpg", "jpeg", "png",
                                                        "tif") else extension
            image_path = (name if os.path.isabs(name)
                          else os.path.join(source_path, name)) + ext
            if not os.path.exists(image_path):
                continue
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            w, h = _image_size(image_path)
            if fovx_global is not None:
                fovx = fovx_global
                fovy = focal_to_fov(fov_to_focal(fovx, w), h)
            else:
                fovy = focal_to_fov(frame["fl_y"], h)
                fovx = focal_to_fov(frame["fl_x"], w)
            infos.append(CameraInfo(
                uid=uid0 + i, R=np.transpose(w2c[:3, :3]), T=w2c[:3, 3],
                fovx=fovx, fovy=fovy, image_path=image_path,
                image_name=os.path.basename(image_path).split(".")[0],
                width=w, height=h,
            ))
        return infos

    train = read_split("transforms_train.json", 0)
    test = read_split("transforms_test.json", len(train)) if os.path.exists(
        os.path.join(source_path, "transforms_test.json")) else []

    plys = _glob.glob(os.path.join(source_path, "*.ply"))
    if not plys:
        raise FileNotFoundError(
            f"MatrixCity scene needs a tiepoint .ply in {source_path}")
    pcd = _fetch_ply(plys[0])
    return SceneInfo(
        point_cloud=pcd, train_cameras=train, test_cameras=test,
        nerf_normalization=nerfpp_norm(train), ply_path=plys[0],
    )


def read_blender_scene(
    source_path: str,
    white_background: bool = False,
    eval_split: bool = True,
    extension: str = ".png",
    num_init_points: int = 100_000,
) -> SceneInfo:
    """NeRF-synthetic (Blender transforms_{train,test}.json) reader."""

    def read_split(transforms_file: str, uid0: int) -> List[CameraInfo]:
        with open(os.path.join(source_path, transforms_file)) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        infos = []
        bg = (np.array([1.0, 1.0, 1.0]) if white_background
              else np.array([0.0, 0.0, 0.0]))
        for i, frame in enumerate(meta["frames"]):
            image_path = os.path.join(source_path, frame["file_path"] + extension)
            # NeRF c2w: OpenGL convention — flip y/z columns to COLMAP-style
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            R = np.transpose(w2c[:3, :3])
            T = w2c[:3, 3]
            w, h = _image_size(image_path)
            fovy = focal_to_fov(fov_to_focal(fovx, w), h)
            infos.append(CameraInfo(
                uid=uid0 + i, R=R, T=T, fovx=fovx, fovy=fovy,
                image_path=image_path,
                image_name=os.path.basename(image_path).split(".")[0],
                width=w, height=h, bg=bg,
            ))
        return infos

    train = read_split("transforms_train.json", 0)
    test = (read_split("transforms_test.json", len(train))
            if eval_split and os.path.exists(
                os.path.join(source_path, "transforms_test.json"))
            else [])
    if not eval_split:
        train, test = train + test, []

    ply_path = os.path.join(source_path, "points3d.ply")
    if not os.path.exists(ply_path):
        # random init in [-1.3, 1.3]^3
        rng = np.random.default_rng(0)
        xyz = rng.random((num_init_points, 3)) * 2.6 - 1.3
        rgb = rng.random((num_init_points, 3))
        write_ply(ply_path, {
            "x": xyz[:, 0].astype(np.float32),
            "y": xyz[:, 1].astype(np.float32),
            "z": xyz[:, 2].astype(np.float32),
            "red": (rgb[:, 0] * 255).astype(np.uint8),
            "green": (rgb[:, 1] * 255).astype(np.uint8),
            "blue": (rgb[:, 2] * 255).astype(np.uint8),
        })
    pcd = _fetch_ply(ply_path)

    return SceneInfo(
        point_cloud=pcd,
        train_cameras=train,
        test_cameras=test,
        nerf_normalization=nerfpp_norm(train),
        ply_path=ply_path,
    )
