"""Write the raytraced structured scene to disk as a COLMAP dataset: the
port's counterpart of scripts/export_structured_dataset.py.

    python -m grendel_tpu_torch.scripts.export_structured_dataset --out /path/ds \\
        --size 1280x832 --cams 72 --points 100000 --seed 0

Writes ``sparse/0/{cameras,images,points3D}.bin`` (data/colmap.py's
writers) and one PNG per view (utils/png.py, no PIL), so that training
with ``-s <dir> --eval`` runs the whole on-disk path: COLMAP parse,
reader, resolution rules, the llffhold split and the trainer. Image names
follow the azimuth order (view_000, ...) and the reader sorts by name, so
``--eval --llffhold`` holds out the views testing.StructuredSyntheticScene
holds out. Host work only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def export_structured_dataset(out: str, width: int, height: int,
                              n_cams: int, n_points: int, seed: int,
                              llffhold: int = 8) -> None:
    from ..testing import StructuredSyntheticScene

    scene = StructuredSyntheticScene(
        width=width, height=height, n_cams=n_cams,
        n_init_points=n_points, seed=seed, llffhold=llffhold)
    write_dataset(out, scene.train_cameras + scene.test_cameras,
                  scene.point_cloud)


def write_dataset(out: str, cameras, point_cloud) -> None:
    """Write ``cameras`` (one PINHOLE intrinsic, that of the first; each
    with its ground truth) and ``point_cloud`` as a COLMAP dataset under
    ``out``: one PNG a view and :func:`write_colmap`'s ``sparse/0``."""
    from ..utils.png import write_png

    img_dir = os.path.join(out, "images")
    os.makedirs(img_dir, exist_ok=True)
    for c in cameras:
        write_png(os.path.join(img_dir, f"{c.image_name}.png"),
                  c.gt().transpose(1, 2, 0))
    write_colmap(out, cameras, point_cloud)


def write_colmap(out: str, cameras, point_cloud,
                 suffix: str = ".png") -> None:
    """Write ``sparse/0/{cameras,images,points3D}.bin`` under ``out`` for
    ``cameras`` (one PINHOLE intrinsic, that of the first), naming view
    ``c`` ``c.image_name + suffix``, and ``point_cloud``."""
    from ..data.colmap import (ColmapCamera, ColmapImage, rotmat_to_qvec,
                               write_cameras_binary, write_images_binary,
                               write_points3d_binary)

    cams = sorted(cameras, key=lambda c: c.uid)
    sparse = os.path.join(out, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    images = {}
    for c in cams:
        # COLMAP stores world-to-camera: the qvec of R_w2c (Camera.R^T;
        # the reader transposes it back) and tvec = Camera.T
        images[c.uid + 1] = ColmapImage(
            id=c.uid + 1, qvec=rotmat_to_qvec(c.R.T),
            tvec=np.asarray(c.T, np.float64), camera_id=1,
            name=f"{c.image_name}{suffix}")

    c0 = cams[0]
    width, height = c0.width, c0.height
    fx = width / (2.0 * c0.tanfovx)
    fy = height / (2.0 * c0.tanfovy)
    write_cameras_binary(
        os.path.join(sparse, "cameras.bin"),
        {1: ColmapCamera(id=1, model="PINHOLE", width=width, height=height,
                         params=np.array([fx, fy, width / 2.0, height / 2.0]))})
    write_images_binary(os.path.join(sparse, "images.bin"), images)
    pcd = point_cloud
    write_points3d_binary(
        os.path.join(sparse, "points3D.bin"), pcd.points.astype(np.float64),
        np.clip(pcd.colors * 255.0, 0, 255).astype(np.uint8))
    print(f"exported {len(cams)} views ({width}x{height}) + "
          f"{pcd.points.shape[0]} points to {out}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Export the structured scene "
                                 "as a COLMAP dataset")
    ap.add_argument("--out", required=True)
    ap.add_argument("--size", default="1280x832")
    ap.add_argument("--cams", type=int, default=72)
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--llffhold", type=int, default=8)
    a = ap.parse_args(argv)
    w, h = (int(x) for x in a.size.split("x"))
    export_structured_dataset(a.out, w, h, a.cams, a.points, a.seed,
                              a.llffhold)


if __name__ == "__main__":
    main()
