"""Gaussian model state: fixed-capacity raw parameters plus an alive mask.

Counterpart of grendel_tpu/models/gaussian_model.py. Every tensor has a
capacity N on its leading axis; ``alive`` marks live slots, and dead slots
render as opacity 0 (projection culls them). The raw parameterization is
the 3DGS one: log-scales, logit-opacity, unnormalized quaternions, and SH
split into the DC band and the rest. Initialization from a point cloud
(kNN scales) belongs to training and is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..device import DEFAULT_DEVICE, resolve_device


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
