"""Plain training step: the reference's render, loss, gradients and Adam.

One step renders each camera of the batch, sums the per-camera losses,
takes the gradient of that sum with respect to the raw parameters, divides
it by the batch size (the "sqrt" batch scaling of Grendel's optimizer:
learning rates times sqrt(bsz), epsilon over sqrt(bsz), betas to the power
bsz) and applies one bias-corrected Adam step to the live Gaussians. The
position learning rate follows 3DGS's log-linear schedule of the image
count.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, NamedTuple

import torch

from . import densify as D
from . import render as R

class Optim(NamedTuple):
    """Adam's settings as a configuration states them, before the batch
    scaling."""

    position_lr_init: float
    position_lr_final: float
    position_lr_max_steps: int
    spatial_lr_scale: float
    feature_lr: float
    opacity_lr: float
    scaling_lr: float
    rotation_lr: float
    lambda_dssim: float
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-15


class RenderSpec(NamedTuple):
    h: int
    w: int
    tile_w: int
    tile_h: int
    max_per_tile: int


@contextlib.contextmanager
def exact_float32():
    """Float32 products stay float32: no TF32 in matmul or convolution."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def lrs(opt: Optim, bsz: int, iteration: int) -> dict:
    """Per-leaf learning rates at ``iteration`` images, batch-scaled."""
    s = math.sqrt(bsz)
    t = min(max(iteration / opt.position_lr_max_steps, 0.0), 1.0)
    xyz = math.exp(math.log(opt.position_lr_init) * (1 - t)
                   + math.log(opt.position_lr_final) * t)
    return {"means3d": xyz * opt.spatial_lr_scale * s,
            "sh_dc": opt.feature_lr * s, "sh_rest": opt.feature_lr / 20 * s,
            "scales_raw": opt.scaling_lr * s, "quats": opt.rotation_lr * s,
            "opacities_raw": opt.opacity_lr * s}


def loss_and_grads(params: dict, alive, cams: List[R.Camera], gts, bg,
                   spec: RenderSpec, sh_degree: int, lambda_dssim: float,
                   dtype=torch.float32, taps: list = None):
    """(summed loss, per-leaf gradients of it, per-camera Walks, images)
    of one batch. ``gts`` are (3, H, W) uint8 tensors. With ``taps`` each
    camera's (gradient of its loss at the projected centres, radii) is
    appended to it."""
    leaves = {k: v.detach().to(dtype).requires_grad_(True)
              for k, v in params.items()}
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    total, walks, images = 0.0, [], []
    for cam, gt_u8 in zip(cams, gts):
        s = R.project(leaves, alive, cam, spec.h, spec.w, sh_degree, dtype)
        lists = R.tile_lists(s, spec.h, spec.w, spec.tile_w, spec.tile_h)
        with torch.no_grad():
            img, walk = R.render(s, lists, spec.h, spec.w, spec.tile_w,
                                 spec.tile_h, spec.max_per_tile, bg, dtype)
        img = img.detach().requires_grad_(True)
        gt = gt_u8.to(dtype) / 255.0
        loss = R.camera_loss(img, gt, lambda_dssim)
        (g_img,) = torch.autograd.grad(loss, img)
        # the blend's cotangent flows into detached splat leaves, block by
        # block; projection's graph then carries it to the parameters
        flat = [x.detach().requires_grad_(True)
                for x in (s.means2d, s.conic, s.color, s.opacity)]
        sd = s._replace(means2d=flat[0], conic=flat[1], color=flat[2],
                        opacity=flat[3])
        R.render(sd, lists, spec.h, spec.w, spec.tile_w, spec.tile_h,
                 spec.max_per_tile, bg, dtype, grad_img=g_img)
        outs = [(o, f.grad) for o, f in
                zip((s.means2d, s.conic, s.color, s.opacity), flat)
                if f.grad is not None]
        g = torch.autograd.grad([o for o, _ in outs], list(leaves.values()),
                                [gr for _, gr in outs], allow_unused=True)
        if taps is not None:
            taps.append((flat[0].grad if flat[0].grad is not None
                         else torch.zeros_like(flat[0]), s.radius))
        for k, gk in zip(leaves, g):
            if gk is not None:
                grads[k] += gk
        total = total + float(loss.detach())
        walks.append(walk)
        images.append(img.detach())
    return total, grads, walks, images


def adam(params: dict, grads: dict, state: dict, lr: dict, bsz: int,
         opt: Optim, alive):
    """One bias-corrected Adam step of the live rows; ``state`` holds the
    moments ``m``, ``v`` (dicts) and the step ``count``. Returns new
    params and state."""
    b1, b2 = opt.betas[0] ** bsz, opt.betas[1] ** bsz
    eps = opt.eps / math.sqrt(bsz)
    count = state["count"] + 1
    bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
    new_p, m_new, v_new = {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(p.dtype)
        m = b1 * state["m"][k] + (1 - b1) * g
        v = b2 * state["v"][k] + (1 - b2) * g * g
        upd = lr[k] * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        mask = alive.reshape((-1,) + (1,) * (p.dim() - 1))
        new_p[k] = torch.where(mask, p - upd, p)
        m_new[k], v_new[k] = m, v
    return new_p, {"m": m_new, "v": v_new, "count": count}


def adam_init(params: dict) -> dict:
    return {"m": {k: torch.zeros_like(v) for k, v in params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()},
            "count": 0}


class Steps(NamedTuple):
    losses: list         # each step's summed loss
    grads1: dict         # the first step's gradient as Adam receives it
    params: dict         # the parameters after the last step
    walks: list          # the first step's per-camera Walks
    stats: tuple         # densify statistics after the steps


def run_steps(params: dict, alive, batches, bg, spec: RenderSpec, opt: Optim,
              iteration: int, sh_degree_of, dtype=torch.float32) -> Steps:
    """The steps of ``batches`` (each a (cameras, ground truths) pair) from
    ``params`` at ``iteration`` images, with fresh Adam moments."""
    with exact_float32():
        p = {k: v.to(dtype) for k, v in params.items()}
        st = adam_init(p)
        losses, grads1, walks1 = [], None, None
        n = alive.shape[0]
        stats = tuple(torch.zeros(n, device=alive.device) for _ in range(3))
        for cams, gts in batches:
            bsz = len(cams)
            taps = []
            loss, g, walks, _ = loss_and_grads(
                p, alive, cams, gts, bg, spec, sh_degree_of(iteration),
                opt.lambda_dssim, dtype, taps)
            for g2, radius in taps:
                stats = D.accumulate(stats, g2, radius, spec.w, spec.h)
            g = {k: v / bsz for k, v in g.items()}
            if grads1 is None:
                grads1, walks1 = g, walks
            p, st = adam(p, g, st, lrs(opt, bsz, iteration), bsz, opt, alive)
            losses.append(loss)
            iteration += bsz
    return Steps(losses, grads1, p, walks1, stats)
