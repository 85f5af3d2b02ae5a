"""LPIPS perceptual metric (VGG16 backbone).

Counterpart of grendel_tpu/ops/lpips.py, with the same ``.npz`` weights
layout (see :func:`load_weights`); the reference's lpipsPyTorch downloads
pretrained torchvision VGG16 weights and the LPIPS linear heads at run
time, so here the weights come from a file, and without one the metric is
unavailable (scripts/metrics.py reports LPIPS as null).

The lpips 'vgg' variant:
  * VGG16 features with ReLU activations, tapped after relu1_2, relu2_2,
    relu3_3, relu4_3 and relu5_3;
  * the input scaled to [-1, 1], then shifted and scaled per channel;
  * per tap: unit-normalize along channels, squared difference, the 1x1
    linear head, the spatial mean; the sum over taps.

The convolutions are ``F.conv2d`` with TensorFloat-32 switched off:
cuDNN would otherwise round their inputs to 10-bit mantissas on the card.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device

# channel shift and scale of LPIPS's scaling layer
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# VGG16 conv plan: (out_channels, pool_before)
_VGG16_PLAN = [
    (64, False), (64, False),          # relu1_1, relu1_2  <- tap 0
    (128, True), (128, False),         # relu2_1, relu2_2  <- tap 1
    (256, True), (256, False), (256, False),   # relu3_*   <- tap 2
    (512, True), (512, False), (512, False),   # relu4_*   <- tap 3
    (512, True), (512, False), (512, False),   # relu5_*   <- tap 4
]
_TAPS = [1, 3, 6, 9, 12]


def load_weights(path: str) -> Dict[str, np.ndarray]:
    """Expected keys: conv{i}_w (O,I,3,3), conv{i}_b (O,) for i in 0..12,
    lin{j}_w (C,) for j in 0..4 (the 1x1 head weights, non-negative)."""
    return dict(np.load(path))


class LPIPS(nn.Module):
    """LPIPS distance of two (3, H, W) images in [0, 1], from a weights
    dict in :func:`load_weights`'s layout, on ``device``."""

    def __init__(self, weights: Dict[str, np.ndarray],
                 device=DEFAULT_DEVICE):
        super().__init__()
        dev = resolve_device(device)

        def param(x):
            return nn.Parameter(torch.as_tensor(np.asarray(x, np.float32),
                                                device=dev),
                                requires_grad=False)

        self.conv_w = nn.ParameterList(
            [param(weights[f"conv{i}_w"]) for i in range(len(_VGG16_PLAN))])
        self.conv_b = nn.ParameterList(
            [param(weights[f"conv{i}_b"]) for i in range(len(_VGG16_PLAN))])
        self.lin = nn.ParameterList(
            [param(weights[f"lin{j}_w"]) for j in range(len(_TAPS))])
        self.register_buffer("shift", torch.as_tensor(_SHIFT, device=dev))
        self.register_buffer("scale", torch.as_tensor(_SCALE, device=dev))

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        h = x
        for i, (_, pool) in enumerate(_VGG16_PLAN):
            if pool:
                h = F.max_pool2d(h, 2)
            h = F.relu(F.conv2d(h, self.conv_w[i], self.conv_b[i],
                                padding=1))
            if i in _TAPS:
                feats.append(h)
        return feats

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        def prep(im):
            im = im * 2.0 - 1.0                       # [-1, 1]
            return ((im - self.shift[:, None, None])
                    / self.scale[:, None, None])[None]

        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            f1 = self.features(prep(img1))
            f2 = self.features(prep(img2))
        total = img1.new_zeros(())
        for lin, a, b in zip(self.lin, f1, f2):
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            diff = (a - b) ** 2                       # (1, C, h, w)
            total = total + torch.mean(torch.sum(
                diff * lin[None, :, None, None], dim=1))
        return total


@torch.no_grad()
def lpips(img1: torch.Tensor, img2: torch.Tensor,
          weights: Union[LPIPS, Dict[str, np.ndarray]]) -> torch.Tensor:
    """LPIPS distance between (3, H, W) images in [0, 1]; ``weights`` is an
    :class:`LPIPS` or a weights dict (a module is built on the images'
    device)."""
    if not isinstance(weights, LPIPS):
        weights = LPIPS(weights, device=img1.device)
    return weights(img1, img2)


def lpips_available(weights_path: Optional[str]) -> bool:
    return bool(weights_path) and os.path.exists(weights_path)
