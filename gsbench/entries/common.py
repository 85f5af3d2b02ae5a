"""What the entries share: the program's kernels built before anything is
timed, a cell's generator, render capacities, the reference's inputs."""

from __future__ import annotations

import numpy as np
import torch

from .. import scene
from ..reference import render as R
from ..reference.step import Optim, RenderSpec


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def build_kernels(device) -> None:
    """Every CUDA kernel of the program built (or found built) and loaded
    at once, before any shape is warmed up."""
    if device.type == "cuda":
        from grendel_tpu_torch import kernels
        kernels.build()
        for name in kernels.SOURCES:
            kernels.load(name)


def mantissa_cap(n: float, floor: int = 1 << 14, align: int = 128) -> int:
    """``n`` rounded up to a step of 1/8 of its power of two, then to
    ``align``: the capacities' rounding rule of the garden benchmark."""
    n = max(int(n), floor)
    k = max(int(np.floor(np.log2(n))) - 3, 7)
    cap = -(-n // (1 << k)) << k
    return -(-cap // align) * align


def entry_count(params, alive, cam, h, w, tw, th, sh_degree) -> int:
    """The reference's tile-list entries of one camera, before the corner
    cull: what an entry capacity must hold."""
    with torch.no_grad():
        s = R.project(params, alive, cam, h, w, sh_degree)
        return R.entry_demand(s, h, w, tw, th)


def optim(cfg: dict, spatial_lr_scale: float) -> Optim:
    o = cfg["optimizer"]
    return Optim(o["position_lr_init"], o["position_lr_final"],
                 o["position_lr_max_steps"], spatial_lr_scale,
                 o["feature_lr"], o["opacity_lr"], o["scaling_lr"],
                 o["rotation_lr"], o["lambda_dssim"])


def spec(cfg: dict, h: int, w: int) -> RenderSpec:
    return RenderSpec(h, w, cfg["tile_w"], cfg["tile_h"], cfg["max_per_tile"])


def program_camera(cam: scene.HostCamera, device):
    """The program's batched camera tensors (one camera) from the same
    matrices the reference takes."""
    from grendel_tpu_torch.cameras import CameraArrays
    return CameraArrays(*(torch.as_tensor(x, device=device)[None]
                          for x in scene.matrices(cam)))


def leaves(params) -> dict:
    """A program's GaussianParams as the reference's dict of leaves."""
    return {k: getattr(params, k) for k in params._fields}


def peak_bytes(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evidence(tr, kind: str, units: int, **extra) -> dict:
    """What the per-layer readers read of a traced window of ``units``
    steps (``kind`` "train" or "loop") or frames ("render")."""
    from .. import trace as T

    inside = T.clip(tr.device, tr.window)
    kernel_s: dict = {}
    for a in tr.device:
        kernel_s[a.name] = kernel_s.get(a.name, 0.0) + (a.end - a.start) / 1e6
    return dict(
        kind=kind, units=units, window_s=tr.window_s,
        busy_s=T.union_s(inside),
        device_s=sum((e - s) / 1e6 for s, e in inside),
        launches=sum(1 for a in tr.device if a.kernel),
        kernel_s=kernel_s, breakdown=T.breakdown(tr), **extra)
