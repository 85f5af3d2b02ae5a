"""Synthetic scenes and cameras for tests, benchmarks and the chip smoke run.

Counterpart of the scene helpers of grendel_tpu/testing.py. Random draws
come from numpy (``np.random.default_rng(seed)``), so a test can hand the
very same values to both packages; the distributions match the JAX
package's, its random bits cannot be reproduced.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from .cameras import Camera
from .device import DEFAULT_DEVICE, resolve_device
from .models.gaussian_model import GaussianParams
from .ops.sh import rgb_to_sh


def make_test_camera(width: int = 64, height: int = 48, dist: float = 4.0,
                     fovx: float = 1.0, angle: float = 0.0) -> Camera:
    """Camera on a circle of radius ``dist`` in the xz-plane looking at origin."""
    # w2c: rotate by -angle about y, then translate back by dist along z
    ca, sa = np.cos(angle), np.sin(angle)
    R_w2c = np.array([[ca, 0, -sa], [0, 1, 0], [sa, 0, ca]], dtype=np.float64)
    t_w2c = np.array([0.0, 0.0, dist])
    fovy = 2 * np.arctan(np.tan(fovx / 2) * height / width)
    return Camera(
        uid=0, image_name=f"test_{angle:.2f}",
        R=R_w2c.T, T=t_w2c, fovx=fovx, fovy=float(fovy),
        width=width, height=height,
    )


def random_gaussians(seed: int, n: int, extent: float = 1.5,
                     sh_degree: int = 3, scale_range=(-4.5, -2.5),
                     opacity_range=(0.3, 0.95)):
    """Random Gaussians centered at the origin, activated form, as float32
    numpy arrays: (means (n,3), scales (n,3), quats (n,4), opacities (n,),
    sh (n,K,3))."""
    rng = np.random.default_rng(seed)
    k_sh = (sh_degree + 1) ** 2
    means = rng.uniform(-extent, extent, (n, 3))
    scales = np.exp(rng.uniform(scale_range[0], scale_range[1], (n, 3)))
    quats = rng.standard_normal((n, 4))
    opac = rng.uniform(opacity_range[0], opacity_range[1], n)
    sh = np.zeros((n, k_sh, 3))
    sh[:, 0, :] = rgb_to_sh(rng.uniform(0.1, 0.9, (n, 3)))
    sh[:, 1:, :] = 0.05 * rng.standard_normal((n, k_sh - 1, 3))
    f32 = lambda x: x.astype(np.float32)
    return f32(means), f32(scales), f32(quats), f32(opac), f32(sh)


def params_fields(means, scales, quats, opac, sh, capacity: int):
    """Raw GaussianParams fields (numpy) of activated Gaussians padded to
    ``capacity``, and the alive mask; the same padding as the JAX
    package's benchmark and flagship scenes."""
    n = means.shape[0]
    pad = capacity - n
    if pad < 0:
        raise ValueError(f"{n} Gaussians exceed capacity {capacity}")

    def padn(x, fill=0.0):
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1),
                      constant_values=fill).astype(np.float32)

    o = np.clip(opac, 1e-4, 1 - 1e-4)
    quats_p = padn(quats)
    quats_p[n:, 0] = 1.0
    fields = dict(
        means3d=padn(means),
        sh_dc=padn(sh[:, :1, :]),
        sh_rest=padn(sh[:, 1:, :]),
        scales_raw=padn(np.log(scales), fill=-10.0),
        quats=quats_p,
        opacities_raw=padn(np.log(o / (1.0 - o)), fill=-10.0),
    )
    return fields, np.arange(capacity) < n


class Scene(NamedTuple):
    params: GaussianParams
    alive: torch.Tensor
    cameras: List[Camera]
    img_h: int
    img_w: int
    sh_degree: int


def garden_scene(seed: int = 0, device=DEFAULT_DEVICE, n_live: int = 200_000,
                 capacity: int = 262_144, bsz: int = 2) -> Scene:
    """The garden-scale benchmark scene (bench.py): 1296x840 pixels,
    200,000 live Gaussians in a capacity of 262,144, SH degree 3, extent
    3.0, log-scales in (-5.5, -3.5), and ``bsz`` cameras at distance 5."""
    from .convert import params_from_numpy

    dev = resolve_device(device)
    h, w, sh_degree = 840, 1296, 3
    g = random_gaussians(seed, n_live, extent=3.0, sh_degree=sh_degree,
                         scale_range=(-5.5, -3.5))
    params, alive = params_from_numpy(*params_fields(*g, capacity), dev)
    cams = [make_test_camera(w, h, dist=5.0, angle=0.1 * i) for i in range(bsz)]
    return Scene(params, alive, cams, h, w, sh_degree)
