"""Training loss: (1 - lambda) * L1 + lambda * (1 - SSIM).

Counterpart of grendel_tpu/engine/loss.py: per-camera pixelwise L1 and
SSIM maps, each normalized by the camera's pixel count x 3, summed over
the batch (the caller divides gradients by bsz). The owned-row partial
loss of the JAX package's sharded path (a global pixel count, per-camera
masks in batch_loss) waits for the multi-GPU port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.ssim import pixelwise_l1_with_mask, ssim_map


def camera_loss(
    image: torch.Tensor,            # (3, H, W) rendered
    gt: torch.Tensor,               # (3, H, W) float in [0, 1]
    lambda_dssim: float = 0.2,
    mask: Optional[torch.Tensor] = None,        # (H, W) pixels that count
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (loss, l1, ssim) for one camera."""
    h, w = image.shape[-2:]
    denom = 3.0 * h * w
    m = (torch.ones((h, w), dtype=torch.float32, device=image.device)
         if mask is None else mask.to(torch.float32))
    l1 = torch.sum(pixelwise_l1_with_mask(image, gt, m)) / denom
    ssim_val = torch.sum(ssim_map(image, gt) * m) / denom
    loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim_val)
    return loss, l1, ssim_val


def batch_loss(
    images: torch.Tensor,           # (B, 3, H, W)
    gts: torch.Tensor,              # (B, 3, H, W)
    lambda_dssim: float = 0.2,
    lr_scale_loss: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of per-camera losses. Returns (loss_sum, (B, 2) [l1, ssim]).

    The batch folds into the blur's channel axis: the blur is
    channel-independent, so (B,3,H,W) -> (B*3,H,W) is exact."""
    b, c, h, w = images.shape
    denom = 3.0 * h * w
    s_map = ssim_map(images.reshape(b * c, h, w),
                     gts.reshape(b * c, h, w)).reshape(b, c, h, w)
    l1_map = torch.abs(images - gts)
    l1s = torch.sum(l1_map, dim=(1, 2, 3)) / denom
    ssims = torch.sum(s_map, dim=(1, 2, 3)) / denom
    losses = (1.0 - lambda_dssim) * l1s + lambda_dssim * (1.0 - ssims)
    return torch.sum(losses) * lr_scale_loss, torch.stack([l1s, ssims], dim=-1)
