"""Debug dumps for cross-run and cross-shard diffing.

Counterpart of grendel_tpu/utils/debug.py (the reference's
utils/debug_utils.py:6-86): images, tile masks and flat arrays written as
text, so two runs (or two ranks) can be compared with plain ``diff``. The
functions take tensors on any device, or numpy arrays, and write the JAX
package's text byte for byte.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_image_txt(path: str, image, precision: int = 6) -> None:
    """(C, H, W) image -> text, one pixel per line 'y x: r g b'."""
    arr = _host(image)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    c, h, w = arr.shape
    with open(path, "w") as f:
        f.write(f"# shape {c} {h} {w}\n")
        for y in range(h):
            for x in range(w):
                vals = " ".join(f"{arr[k, y, x]:.{precision}f}"
                                for k in range(c))
                f.write(f"{y} {x}: {vals}\n")


def save_mask_txt(path: str, mask) -> None:
    """(H, W) bool or int mask -> text rows of 0/1."""
    arr = _host(mask).astype(int)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# shape {arr.shape[0]} {arr.shape[1]}\n")
        for row in arr:
            f.write("".join(str(v) for v in row) + "\n")


def save_array_txt(path: str, array, precision: int = 6) -> None:
    """Flat dump of any array, each value after its index."""
    full = _host(array)
    arr = full.reshape(-1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# shape {full.shape}\n")
        for i, v in enumerate(arr):
            f.write(f"{i}: {v:.{precision}f}\n")


def compare_txt_dumps(path_a: str, path_b: str, atol: float = 1e-5) -> int:
    """The number of lines whose numbers differ by more than ``atol``."""
    bad = 0
    with open(path_a) as fa, open(path_b) as fb:
        for la, lb in zip(fa, fb):
            if la.startswith("#") or la == lb:
                continue
            try:
                va = [float(t) for t in la.split(":")[1].split()]
                vb = [float(t) for t in lb.split(":")[1].split()]
                if any(abs(x - y) > atol for x, y in zip(va, vb)):
                    bad += 1
            except (IndexError, ValueError):
                bad += 1
    return bad
