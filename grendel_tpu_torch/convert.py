"""Carry model parameters from numpy (e.g. the JAX package's) into the port.

:func:`params_from_numpy` takes the six ``GaussianParams`` fields as numpy
arrays, named as in both packages, so a model held by ``grendel_tpu``
(``{k: np.asarray(v) for k, v in params._asdict().items()}``) renders in
the port on the same values. A model on disk crosses through its PLY
instead (engine/gaussian_io.py).
"""

from __future__ import annotations

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
        k: torch.as_tensor(np.asarray(fields[k], np.float32), device=dev)
        for k in GaussianParams._fields})
    n = params.means3d.shape[0]
    if any(p.shape[0] != n for p in params):
        raise ValueError("all fields must share the capacity axis")
    alive_t = torch.as_tensor(np.asarray(alive, bool), device=dev)
    if alive_t.shape != (n,):
        raise ValueError(f"alive must be ({n},), got {tuple(alive_t.shape)}")
    return params, alive_t
