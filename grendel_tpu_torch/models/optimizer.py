"""Adam with per-leaf learning rates and batch-size scaling.

Counterpart of grendel_tpu/models/optimizer.py:

  * six parameter groups with their own LRs (xyz follows an exponential
    schedule, features_rest = feature_lr / 20), Adam eps = 1e-15;
  * batch-size scaling: "sqrt" (default) lr *= sqrt(bsz), eps /=
    sqrt(bsz), betas = betas ** bsz; "linear" lr *= bsz; "accumu" none
    (gradients are accumulated, not averaged);
  * the exponential xyz LR schedule (log-linear decay with a sine delay
    ramp).

Hand-rolled rather than ``torch.optim.Adam``: densification operates on
the moments directly (zeroing re-allocated slots, resetting the opacity
moments), which is plain on a NamedTuple state. The update is classic
bias-corrected Adam, masked so dead slots keep their parameters; the
moments of every slot advance, as in the JAX package. It returns new
tensors and does not update in place.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .gaussian_model import GaussianParams


class AdamState(NamedTuple):
    mu: GaussianParams     # first moment per leaf
    nu: GaussianParams     # second moment per leaf
    count: torch.Tensor    # () int32, shared step count for bias correction


class LrConfig(NamedTuple):
    """Per-leaf LRs (xyz comes per step from the schedule) and Adam's
    hyperparameters, all already batch-size scaled (see ``scaled_lrs``)."""

    sh_dc: float
    sh_rest: float
    scales: float
    quats: float
    opacity: float
    beta1: float
    beta2: float
    eps: float


def scaled_lrs(
    feature_lr: float,
    opacity_lr: float,
    scaling_lr: float,
    rotation_lr: float,
    bsz: int,
    lr_scale_mode: str = "sqrt",
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-15,
    lr_scale_pos_and_scale: float = 1.0,
) -> Tuple[LrConfig, float]:
    """The (bsz-scaled) static LR config and ``lr_scale``, which also
    multiplies the xyz schedule's endpoints."""
    if lr_scale_mode == "linear":
        lr_scale = float(bsz)
    elif lr_scale_mode == "sqrt":
        # the JAX package takes the square root in float32
        lr_scale = float(torch.sqrt(torch.tensor(float(bsz))))
        eps = eps / lr_scale
        betas = tuple(b ** bsz for b in betas)
    elif lr_scale_mode == "accumu":
        lr_scale = 1.0
    else:
        raise ValueError(f"unknown lr_scale_mode {lr_scale_mode!r}")
    cfg = LrConfig(
        sh_dc=feature_lr * lr_scale,
        sh_rest=feature_lr / 20.0 * lr_scale,
        scales=scaling_lr * lr_scale_pos_and_scale * lr_scale,
        quats=rotation_lr * lr_scale,
        opacity=opacity_lr * lr_scale,
        beta1=betas[0],
        beta2=betas[1],
        eps=eps,
    )
    return cfg, lr_scale


def expon_lr(
    step,
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
) -> torch.Tensor:
    """Log-linear LR decay with an optional sine delay ramp, in float32 on
    the step's device (a step held as a tensor is never read back)."""
    step = torch.as_tensor(step).to(torch.float32)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1.0 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay = 1.0
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_init = torch.log(torch.tensor(lr_init, dtype=torch.float32,
                                      device=step.device))
    log_final = torch.log(torch.tensor(lr_final, dtype=torch.float32,
                                       device=step.device))
    log_lerp = torch.exp(log_init * (1.0 - t) + log_final * t)
    return torch.where(step < 0, torch.zeros_like(step), delay * log_lerp)


def adam_init(params: GaussianParams) -> AdamState:
    zeros = GaussianParams(*(torch.zeros_like(p) for p in params))
    return AdamState(mu=zeros, nu=GaussianParams(*(z.clone() for z in zeros)),
                     count=torch.zeros((), dtype=torch.int32,
                                       device=params.means3d.device))


def adam_step(
    params: GaussianParams,
    grads: GaussianParams,
    state: AdamState,
    lrs: LrConfig,
    xyz_lr: torch.Tensor,
    alive: torch.Tensor,
) -> Tuple[GaussianParams, AdamState]:
    """One bias-corrected Adam step with per-leaf LRs, masked to live slots."""
    count = state.count + 1
    b1, b2 = lrs.beta1, lrs.beta2
    cf = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=cf.device), cf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=cf.device), cf)
    per_leaf_lr = GaussianParams(
        means3d=xyz_lr, sh_dc=lrs.sh_dc, sh_rest=lrs.sh_rest,
        scales_raw=lrs.scales, quats=lrs.quats, opacities_raw=lrs.opacity)

    new_p, new_m, new_v = [], [], []
    for p, g, m, v, lr in zip(params, grads, state.mu, state.nu, per_leaf_lr):
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
        step_dir = (m_new / bc1) / (torch.sqrt(v_new / bc2) + lrs.eps)
        mask = alive.reshape((-1,) + (1,) * (p.dim() - 1))
        new_p.append(torch.where(mask, p - lr * step_dir, p))
        new_m.append(m_new)
        new_v.append(v_new)
    return GaussianParams(*new_p), AdamState(
        mu=GaussianParams(*new_m), nu=GaussianParams(*new_v), count=count)
