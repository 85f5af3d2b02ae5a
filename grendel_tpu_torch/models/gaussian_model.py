"""Gaussian model state: fixed-capacity raw parameters plus an alive mask.

Counterpart of grendel_tpu/models/gaussian_model.py. Every tensor has a
capacity N on its leading axis; ``alive`` marks live slots, and dead slots
render as opacity 0 (projection culls them). The raw parameterization is
the 3DGS one: log-scales, logit-opacity, unnormalized quaternions, and SH
split into the DC band and the rest. :func:`init_from_pcd` starts a model
from a point cloud (kNN scales).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.knn import mean_dist2_to_knn
from ..ops.sh import rgb_to_sh
from ..utils.math3d import inverse_sigmoid


class GaussianParams(NamedTuple):
    """Model parameters. All leaves have leading axis = capacity."""

    means3d: torch.Tensor        # (N, 3) world-space positions
    sh_dc: torch.Tensor          # (N, 1, 3) SH DC band
    sh_rest: torch.Tensor        # (N, K-1, 3) higher SH bands
    scales_raw: torch.Tensor     # (N, 3) log-scales
    quats: torch.Tensor          # (N, 4) unnormalized quaternions [w, x, y, z]
    opacities_raw: torch.Tensor  # (N,) logit-opacity


class ActivatedGaussians(NamedTuple):
    means3d: torch.Tensor    # (N, 3)
    scales: torch.Tensor     # (N, 3) exp
    quats: torch.Tensor      # (N, 4) still unnormalized (projection normalizes)
    opacities: torch.Tensor  # (N,) sigmoid
    sh: torch.Tensor         # (N, K, 3) concatenated SH


def activated(params: GaussianParams) -> ActivatedGaussians:
    """The standard 3DGS activations."""
    return ActivatedGaussians(
        means3d=params.means3d,
        scales=torch.exp(params.scales_raw),
        quats=params.quats,
        opacities=torch.sigmoid(params.opacities_raw),
        sh=torch.cat([params.sh_dc, params.sh_rest], dim=1),
    )


def num_sh_rest(max_sh_degree: int) -> int:
    return (max_sh_degree + 1) ** 2 - 1


def empty_params(capacity: int, max_sh_degree: int = 3,
                 device=DEFAULT_DEVICE) -> GaussianParams:
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    quats = torch.zeros(capacity, 4, **f32)
    quats[:, 0] = 1.0
    return GaussianParams(
        means3d=torch.zeros(capacity, 3, **f32),
        sh_dc=torch.zeros(capacity, 1, 3, **f32),
        sh_rest=torch.zeros(capacity, num_sh_rest(max_sh_degree), 3, **f32),
        scales_raw=torch.full((capacity, 3), -10.0, **f32),
        quats=quats,
        opacities_raw=torch.full((capacity,), -10.0, **f32),
    )


def init_from_pcd(points: np.ndarray, colors: np.ndarray, capacity: int,
                  max_sh_degree: int = 3, n_shards: int = 1,
                  device=DEFAULT_DEVICE
                  ) -> Tuple[GaussianParams, torch.Tensor]:
    """(params, alive) from a host point cloud: ``points`` (M, 3) and
    ``colors`` (M, 3) in [0, 1].

    SH DC from the colors, the rest zero; isotropic log-scale from the
    square root of the mean squared distance to the 3 nearest neighbors
    (at least 1e-7); identity rotation; opacity 0.1. ``n_shards`` > 1
    splits the points into equal capacity blocks, contiguous chunk d at
    offset d * capacity / n_shards, as the JAX package lays out a sharded
    model."""
    dev = resolve_device(device)
    m = points.shape[0]
    if m > capacity:
        raise ValueError(f"point cloud ({m}) exceeds capacity ({capacity})")
    if capacity % n_shards:
        raise ValueError(f"capacity {capacity} is not a multiple of "
                         f"{n_shards} shards")
    dist2 = np.maximum(mean_dist2_to_knn(points, k=3), 1e-7)
    log_scale = np.log(np.sqrt(dist2))
    block = capacity // n_shards
    idx = torch.as_tensor(np.concatenate([
        d * block + np.arange((d + 1) * m // n_shards - d * m // n_shards)
        for d in range(n_shards)]).astype(np.int64), device=dev)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    params = empty_params(capacity, max_sh_degree, dev)
    params.means3d[idx] = f32(points)
    params.sh_dc[idx] = f32(rgb_to_sh(np.asarray(colors, np.float32)))[:, None]
    params.scales_raw[idx] = f32(log_scale)[:, None].expand(m, 3)
    params.opacities_raw[idx] = inverse_sigmoid(torch.tensor(0.1)).item()
    alive = torch.zeros(capacity, dtype=torch.bool, device=dev)
    alive[idx] = True
    return params, alive


def pad_to_capacity(params: GaussianParams, alive: torch.Tensor,
                    new_capacity: int) -> Tuple[GaussianParams, torch.Tensor]:
    """Grow the capacity axis; new slots are dead and hold the empty
    values of :func:`empty_params`."""
    old = alive.shape[0]
    if new_capacity < old:
        raise ValueError("cannot shrink capacity")
    fill = empty_params(new_capacity - old, num_sh_degree(params),
                        alive.device)
    grown = GaussianParams(*(torch.cat([p, f.to(p.dtype)])
                             for p, f in zip(params, fill)))
    dead = torch.zeros(new_capacity - old, dtype=torch.bool,
                       device=alive.device)
    return grown, torch.cat([alive, dead])


def num_sh_degree(params: GaussianParams) -> int:
    """Max SH degree that the parameter layout holds."""
    return round((params.sh_rest.shape[1] + 1) ** 0.5) - 1


def count_alive(alive: torch.Tensor) -> torch.Tensor:
    return torch.sum(alive.to(torch.int32))


def round_capacity(n: int, multiple: int = 256) -> int:
    """Round a desired capacity up to a multiple."""
    return int(-(-n // multiple) * multiple)
