"""Make the JPEG fixtures of this directory (run from the repository root,
on a machine with PIL):

    JAX_PLATFORMS=cpu python tests/data/jpeg/make_fixtures.py

Writes, with PIL's encoder:

  * ``<kind>.jpg``, small images of odd sizes (a seeded gradient with
    noise), one of each kind the port's decoder takes: 4:4:4, 4:2:2 and
    4:2:0 chroma at quality 75, 4:2:0 at 95, grey, progressive, restart
    markers; beside each, ``<kind>.png``, PIL's decode of it
    (``np.asarray(Image.open(...))``) as a filter-0 PNG;
  * ``truck/view_XXX.jpg``, the structured scene's 10 views raytraced at
    1957x1091 (the size of Tanks&Temples' truck in the 3DGS release), at
    quality 90, 4:2:0, baseline; and ``truck/sha256.json``, the sha256 of
    the bytes of each view's ground truth as the JAX package decodes it
    (``grendel_tpu.data.scene.decode_image`` at 1600x891, the ``-r -1``
    rule's size: PIL's decode and PIL's bilinear resize).

chip_smoke.py (phase 15) and tests/test_torch_image_decode.py hold the
port's decoder and resize to these files. Nothing in the port imports
this script.
"""

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

# kind -> (width, height, PIL save options); odd sizes, none a multiple of
# an MCU
KINDS = {
    "s444_q75": (37, 23, dict(quality=75, subsampling=0)),
    "s422_q75": (45, 29, dict(quality=75, subsampling=1)),
    "s420_q75": (53, 41, dict(quality=75, subsampling=2)),
    "s420_q95": (61, 19, dict(quality=95, subsampling=2)),
    "grey": (39, 27, dict(quality=80)),
    "progressive": (71, 43, dict(quality=85, subsampling=2,
                                 progressive=True)),
    "restart": (67, 35, dict(quality=85, subsampling=2,
                             restart_marker_blocks=3)),
}
TRUCK_SIZE, TRUCK_CAMS, TRUCK_QUALITY = (1957, 1091), 10, 90
TRUCK_DECODE = (1600, 891)


def small_image(w, h, seed, grey=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([3 * xx + 5 * yy, 200 - 2 * xx + yy,
                     (xx * yy) % 97 + 60], axis=-1)
    img = np.clip(base + rng.integers(0, 24, base.shape), 0, 255)
    img = img.astype(np.uint8)
    return img[..., 0] if grey else img


def main():
    from PIL import Image

    from grendel_tpu.data.readers import CameraInfo
    from grendel_tpu.data.scene import decode_image
    from grendel_tpu_torch.testing import StructuredSyntheticScene
    from grendel_tpu_torch.utils.png import write_png

    for seed, (kind, (w, h, opts)) in enumerate(sorted(KINDS.items())):
        path = os.path.join(HERE, f"{kind}.jpg")
        Image.fromarray(small_image(w, h, seed, kind == "grey")).save(
            path, **opts)
        with Image.open(path) as im:
            write_png(os.path.join(HERE, f"{kind}.png"), np.asarray(im))

    truck = os.path.join(HERE, "truck")
    os.makedirs(truck, exist_ok=True)
    scene = StructuredSyntheticScene(
        width=TRUCK_SIZE[0], height=TRUCK_SIZE[1], n_cams=TRUCK_CAMS,
        n_init_points=1000, seed=0)
    digests = {}
    for cam in sorted(scene.train_cameras + scene.test_cameras,
                      key=lambda c: c.uid):
        name = f"{cam.image_name}.jpg"
        path = os.path.join(truck, name)
        Image.fromarray(cam.gt().transpose(1, 2, 0)).save(
            path, quality=TRUCK_QUALITY, subsampling=2)
        info = CameraInfo(uid=cam.uid, R=np.eye(3), T=np.zeros(3), fovx=1.0,
                          fovy=1.0, image_path=path, image_name=name,
                          width=TRUCK_SIZE[0], height=TRUCK_SIZE[1])
        gt = decode_image(info, size=TRUCK_DECODE)
        assert gt.shape == (3, TRUCK_DECODE[1], TRUCK_DECODE[0])
        digests[name] = hashlib.sha256(gt.tobytes()).hexdigest()
    with open(os.path.join(truck, "sha256.json"), "w") as f:
        json.dump({"size": list(TRUCK_DECODE), "sha256": digests}, f,
                  indent=1, sort_keys=True)
        f.write("\n")
    for root, _, files in os.walk(HERE):
        for name in sorted(files):
            path = os.path.join(root, name)
            print(f"{os.path.relpath(path, HERE)}: {os.path.getsize(path)} "
                  f"bytes")


if __name__ == "__main__":
    main()
