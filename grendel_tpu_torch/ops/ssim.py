"""L1 / SSIM loss math.

Counterpart of grendel_tpu/ops/ssim.py: scalar l1/l2, the 11x11
Gaussian-window SSIM with zero-padded borders, and the pixelwise masked
maps the distributed loss path uses. Plain PyTorch, as the JAX package
left this to XLA outside any kernel.

The window is separable, so the blur runs as two 1-D passes of an explicit
k-tap shift-multiply-add in float32, as in the JAX package. It is not a
cuDNN convolution: on the card a float32 convolution runs in TF32 by
default, which keeps about three decimal digits, the error class of the
~5e-3 SSIM error the JAX package recorded for its bf16 convolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def gaussian_window(window_size: int = 11, sigma: float = 1.5,
                    device=None) -> torch.Tensor:
    x = (torch.arange(window_size, dtype=torch.float32, device=device)
         - window_size // 2)
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def _depthwise_conv(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """img (C,H,W), window (k,k) -> (C,H,W) with zero padding (SAME), as
    two separable k-tap shift-add passes (see the module docstring)."""
    k = window.shape[0]
    r = k // 2
    # window = g g^T with g normalized, so the column sums give g back
    g1 = torch.sum(window, dim=0)
    out = img
    for dim, pad in ((1, (0, 0, r, r)), (2, (r, r))):
        size = out.shape[dim]
        p = F.pad(out, pad)
        acc = None
        for i in range(k):
            term = g1[i] * p.narrow(dim, i, size)
            acc = term if acc is None else acc + term
        out = acc
    return out


def ssim_map(img1: torch.Tensor, img2: torch.Tensor,
             window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM map for (C,H,W) images in [0,1]. Zero-padded borders."""
    w = gaussian_window(window_size, device=img1.device)
    mu1 = _depthwise_conv(img1, w)
    mu2 = _depthwise_conv(img2, w)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = _depthwise_conv(img1 * img1, w) - mu1_sq
    sigma2_sq = _depthwise_conv(img2 * img2, w) - mu2_sq
    sigma12 = _depthwise_conv(img1 * img2, w) - mu12
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    return ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Scalar mean SSIM over (C,H,W)."""
    return torch.mean(ssim_map(img1, img2, window_size))


def pixelwise_l1_with_mask(pred: torch.Tensor, gt: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Masked per-pixel L1 map (C,H,W); mask broadcastable (H,W) or (C,H,W)."""
    return torch.abs(pred - gt) * mask


def pixelwise_ssim_with_mask(pred: torch.Tensor, gt: torch.Tensor,
                             mask: torch.Tensor,
                             window_size: int = 11) -> torch.Tensor:
    return ssim_map(pred, gt, window_size) * mask


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR matching the reference (mean MSE over all elements)."""
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse + 1e-20))
