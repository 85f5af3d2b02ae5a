"""Make the truck cell's views (run once from the repository's root, on a
machine with PIL):

    python3 gsbench/data/truck/make_views.py

Tanks&Temples' truck is 979x546 in the 3DGS release that Grendel trains
on, and ``-r -1`` leaves a view of that width as it is. The real views
are not in the repository, so these are stand-ins: the structured
scene's 10 raytraced views (``tests/data/jpeg/truck``, 1957x1091) taken
down to 979x546 by PIL's Lanczos filter and written as baseline 4:2:0
JPEGs at quality 90. ``sha256.json`` holds the sha256 of each view's
ground truth as PIL decodes it, (3, H, W) uint8: what the program's
decode is held to.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
SOURCE = HERE.parents[2] / "tests" / "data" / "jpeg" / "truck"
SIZE, QUALITY = (979, 546), 90


def main():
    digests = {}
    for src in sorted(SOURCE.glob("view_*.jpg")):
        dst = HERE / src.name
        with Image.open(src) as im:
            im.convert("RGB").resize(SIZE, Image.LANCZOS).save(
                dst, quality=QUALITY, subsampling=2)
        with Image.open(dst) as im:
            arr = np.asarray(im).transpose(2, 0, 1)
        digests[dst.name] = hashlib.sha256(
            np.ascontiguousarray(arr).tobytes()).hexdigest()
    (HERE / "sha256.json").write_text(json.dumps(
        {"size": list(SIZE), "sha256": digests}, indent=1, sort_keys=True)
        + "\n")


if __name__ == "__main__":
    main()
