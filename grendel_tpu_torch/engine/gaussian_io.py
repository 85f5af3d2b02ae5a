"""Model PLY export/import in the standard 3DGS attribute layout.

Counterpart of grendel_tpu/engine/gaussian_io.py, and file-compatible
with it: vertex properties x,y,z, nx,ny,nz (zeros), f_dc_0..2,
f_rest_0..3*(K-1)-1 (channel-major), opacity, scale_0..2, rot_0..3, all
raw (pre-activation) values. A model trained by either package loads into
the other. A directory of per-shard ``point_cloud_rk{r}_ws{w}.ply`` files
loads as their concatenation.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from ..models.gaussian_model import GaussianParams, round_capacity
from ..utils.ply import read_ply, write_ply


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def params_to_ply_fields(params: GaussianParams, alive) -> dict:
    """Pack the live slots of ``params`` (tensors or arrays) into PLY fields."""
    idx = np.nonzero(_host(alive))[0]
    xyz, f_dc, f_rest, scales, quats, opac = (_host(p)[idx] for p in params)
    n = xyz.shape[0]
    fields = {
        "x": xyz[:, 0].astype(np.float32),
        "y": xyz[:, 1].astype(np.float32),
        "z": xyz[:, 2].astype(np.float32),
        "nx": np.zeros(n, np.float32),
        "ny": np.zeros(n, np.float32),
        "nz": np.zeros(n, np.float32),
    }
    # channel-major flattening (n, K, 3) -> (n, 3, K); explicit column
    # counts so n == 0 still writes a valid header
    dc_cm = f_dc.transpose(0, 2, 1).reshape(n, f_dc.shape[1] * 3)
    for i in range(dc_cm.shape[1]):
        fields[f"f_dc_{i}"] = dc_cm[:, i].astype(np.float32)
    rest_cm = f_rest.transpose(0, 2, 1).reshape(n, f_rest.shape[1] * 3)
    for i in range(rest_cm.shape[1]):
        fields[f"f_rest_{i}"] = rest_cm[:, i].astype(np.float32)
    fields["opacity"] = opac.astype(np.float32)
    for i in range(3):
        fields[f"scale_{i}"] = scales[:, i].astype(np.float32)
    for i in range(4):
        fields[f"rot_{i}"] = quats[:, i].astype(np.float32)
    return fields


def save_ply(path: str, params: GaussianParams, alive) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_ply(path, params_to_ply_fields(params, alive))


def _sorted_numeric(names: List[str], prefix: str) -> List[str]:
    sel = [n for n in names if n.startswith(prefix)]
    return sorted(sel, key=lambda n: int(n[len(prefix):]))


def load_ply_fields(path: str) -> Tuple[np.ndarray, ...]:
    """Read one PLY into raw arrays (xyz, sh_dc, sh_rest, scales, quats, opac)."""
    f = read_ply(path)
    n = f["x"].shape[0]
    xyz = np.stack([f["x"], f["y"], f["z"]], -1)
    dc_names = _sorted_numeric(list(f), "f_dc_")
    rest_names = _sorted_numeric(list(f), "f_rest_")
    sh_dc = np.stack([f[k] for k in dc_names], -1).reshape(n, 3, 1)
    sh_dc = sh_dc.transpose(0, 2, 1)                    # (n, 1, 3)
    k_rest = len(rest_names) // 3
    sh_rest = np.stack([f[k] for k in rest_names], -1).reshape(n, 3, k_rest)
    sh_rest = sh_rest.transpose(0, 2, 1)                # (n, k_rest, 3)
    scales = np.stack([f[f"scale_{i}"] for i in range(3)], -1)
    quats = np.stack([f[f"rot_{i}"] for i in range(4)], -1)
    return xyz, sh_dc, sh_rest, scales, quats, f["opacity"]


def _ply_paths(path_or_dir: str) -> List[str]:
    if not os.path.isdir(path_or_dir):
        return [path_or_dir]
    single = os.path.join(path_or_dir, "point_cloud.ply")
    if os.path.exists(single):
        return [single]
    rx = re.compile(r"point_cloud_rk(\d+)_ws(\d+)\.ply$")
    found = sorted((int(m.group(1)), os.path.join(path_or_dir, fn))
                   for fn in os.listdir(path_or_dir)
                   if (m := rx.match(fn)))
    if not found:
        raise FileNotFoundError(f"no point cloud PLY in {path_or_dir}")
    return [p for _, p in found]


def load_ply(path_or_dir: str, capacity: Optional[int] = None,
             shard: Tuple[int, int] = (0, 1), device=DEFAULT_DEVICE):
    """Load a model save (a .ply file, or a directory holding
    ``point_cloud.ply`` or per-shard ``point_cloud_rk{r}_ws{w}.ply``).

    ``capacity`` defaults to the next multiple of 256 over the count;
    ``shard`` = (rank, world_size) keeps that contiguous chunk.
    Returns (GaussianParams on ``device``, alive mask).
    """
    from ..convert import params_from_numpy

    parts = [load_ply_fields(p) for p in _ply_paths(path_or_dir)]
    xyz, sh_dc, sh_rest, scales, quats, opac = (
        np.concatenate([p[i] for p in parts], axis=0) for i in range(6))
    total = xyz.shape[0]
    rank, ws = shard
    lo, hi = rank * total // ws, (rank + 1) * total // ws
    m = hi - lo
    cap = capacity if capacity is not None else round_capacity(max(m, 1))
    if m > cap:
        raise ValueError(f"shard size {m} exceeds capacity {cap}")

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:m] = x[lo:hi]
        return out

    padded_quats = pad(quats)
    padded_quats[m:, 0] = 1.0          # padded slots get a valid rotation
    fields = dict(means3d=pad(xyz), sh_dc=pad(sh_dc), sh_rest=pad(sh_rest),
                  scales_raw=pad(scales, fill=-10.0), quats=padded_quats,
                  opacities_raw=pad(opac, fill=-10.0))
    return params_from_numpy(fields, np.arange(cap) < m, device)
