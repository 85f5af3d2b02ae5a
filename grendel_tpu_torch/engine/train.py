"""Single-GPU training step: render batch -> loss -> backward -> Adam.

Counterpart of grendel_tpu/engine/train.py. One step renders ``bsz``
cameras through one camera-blocked tile list and one blend (kernels K1
and K3 on the card), sums their losses, backpropagates to the Gaussian
parameters (the blend's backward is kernel K2 on the card), scales each
Gaussian's gradients by its visibility count as grad_normalization_mode
says (the JAX package's one-device step runs in replicated mode, which
applies it), divides them by bsz (unless lr_scale_mode == "accumu"),
accumulates the
densification statistics from the screen-space position gradients, and
applies one Adam step at the xyz LR the schedule gives for the current
iteration.

The step is a function of TrainState and returns a new one; the host
loop around it is engine/trainer.py. ``iteration`` stays a tensor on the
state's device, so a step never reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..cameras import CameraArrays
from ..models.densify import (DensifyStats, accumulate_densify_stats,
                              densify_stats_init)
from ..models.gaussian_model import GaussianParams
from ..models.optimizer import (AdamState, LrConfig, adam_init, adam_step,
                                expon_lr)
from .loss import batch_loss
from .render import RenderConfig, render_batch


class TrainState(NamedTuple):
    params: GaussianParams
    alive: torch.Tensor         # (N,) bool
    adam: AdamState
    stats: DensifyStats
    iteration: torch.Tensor     # () int32, advances by bsz per step


class XyzLrSchedule(NamedTuple):
    """Endpoints already multiplied by spatial_lr_scale * lr_scale."""

    lr_init: float
    lr_final: float
    lr_delay_mult: float
    max_steps: int

    def __call__(self, step) -> torch.Tensor:
        return expon_lr(step, self.lr_init, self.lr_final, lr_delay_steps=0,
                        lr_delay_mult=self.lr_delay_mult,
                        max_steps=self.max_steps)


def train_state_init(params: GaussianParams, alive: torch.Tensor,
                     start_iteration: int = 0) -> TrainState:
    dev = alive.device
    return TrainState(
        params=params,
        alive=alive,
        adam=adam_init(params),
        stats=densify_stats_init(alive.shape[0], dev),
        iteration=torch.tensor(start_iteration, dtype=torch.int32, device=dev),
    )


def normalize_grads_by_visibility(grads: GaussianParams, radii,
                                  mode: str) -> GaussianParams:
    """Scale each Gaussian's gradients by the number of batch views it is
    visible in (radius > 0 in ``radii`` (B, N)): 1/count, count or count²
    (the reference's --grad_normalization_mode, arguments/__init__.py:157).
    The distributed step's replicated mode applies it too: every rank
    projects the whole batch there, so the count needs no collective."""
    if mode == "none":
        return grads
    vis = torch.sum(radii > 0, dim=0).to(torch.float32)
    if mode == "divide_by_visible_count":
        factor = 1.0 / torch.clamp(vis, min=1.0)
    elif mode == "multiply_by_visible_count":
        factor = vis
    elif mode == "square_multiply_by_visible_count":
        factor = vis * vis
    else:
        raise ValueError(f"unknown grad_normalization_mode {mode!r}")
    return GaussianParams(*(g * factor.reshape((-1,) + (1,) * (g.dim() - 1))
                            for g in grads))


def train_step(
    state: TrainState,
    cams: CameraArrays,            # batched (bsz, ...) leaves
    gt_u8: torch.Tensor,           # (bsz, 3, H, W) uint8 ground truth
    bg: torch.Tensor,              # (3,) background color
    render_cfg: RenderConfig,
    sh_degree: int,
    bsz: int,
    lambda_dssim: float,
    lrs: LrConfig,
    xyz_sched: XyzLrSchedule,
    lr_scale_mode: str = "sqrt",
    lr_scale_loss: float = 1.0,
    grad_normalization_mode: str = "none",
) -> Tuple[TrainState, dict]:
    """One training step. Returns (new_state, metrics)."""
    n = state.alive.shape[0]
    gt = gt_u8.to(torch.float32) / 255.0
    leaves = [p.detach().requires_grad_(True) for p in state.params]
    tap = torch.zeros((bsz, n, 2), dtype=torch.float32,
                      device=state.alive.device, requires_grad=True)
    images, splats, aux = render_batch(
        GaussianParams(*leaves), state.alive, cams, sh_degree, render_cfg,
        bg=bg, means2d_tap=tap)
    loss, per_cam = batch_loss(images, gt, lambda_dssim,
                               lr_scale_loss=lr_scale_loss)
    *grads, tap_grad = torch.autograd.grad(loss, leaves + [tap])
    # the tap gradient stays raw: the densify statistics read it unscaled
    grads = normalize_grads_by_visibility(GaussianParams(*grads),
                                          splats.radii,
                                          grad_normalization_mode)

    # param.grad /= bsz unless "accumu" (gradients accumulated, not averaged)
    if lr_scale_mode != "accumu":
        grads = GaussianParams(*(g / bsz for g in grads))

    stats = accumulate_densify_stats(state.stats, tap_grad, splats.radii,
                                     render_cfg.img_w, render_cfg.img_h)
    xyz_lr = xyz_sched(state.iteration)
    params, adam = adam_step(state.params, grads, state.adam, lrs, xyz_lr,
                             state.alive)
    new_state = TrainState(params=params, alive=state.alive, adam=adam,
                           stats=stats, iteration=state.iteration + bsz)
    metrics = {
        "loss": loss.detach(),
        "l1": per_cam[:, 0].detach(),
        "ssim": per_cam[:, 1].detach(),
        "xyz_lr": xyz_lr,
        "num_isects": aux.num_isects,
    }
    return new_state, metrics
