"""Front-to-back alpha blending math shared by the plain rasterizers.

Counterpart of grendel_tpu/ops/blend.py. For each pixel, walk Gaussians
front to back; alpha = min(0.99, opacity * exp(power)); skip if power > 0
or alpha < 1/255; a pixel is done at the first entry whose
``T * (1 - alpha) < 1e-4``, and that entry and every later one are left
out (the reference CUDA rasterizer's stop rule).

The JAX package decides inclusion per window of entries from a cumulative
product, so after an exclusion a later low-alpha entry of the next window
can still be included there. The two rules differ only on pixels that have
already saturated; the CPU tests bound that difference.
"""

from __future__ import annotations

import torch

ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


def splat_alpha(dx: torch.Tensor, dy: torch.Tensor, conic: torch.Tensor,
                opacity: torch.Tensor) -> torch.Tensor:
    """Alpha of Gaussians at pixel offsets.

    dx, dy: (..., K, P) pixel-minus-mean offsets; conic: (..., K, 3);
    opacity: (..., K). Returns (..., K, P) alphas with the skip rules
    applied (skipped contributions are exactly 0).
    """
    a, b, c = conic[..., 0:1], conic[..., 1:2], conic[..., 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = (opacity[..., None] * torch.exp(power)).clamp(max=ALPHA_CLAMP)
    keep = (power <= 0.0) & (alpha >= ALPHA_MIN)
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def blend_weights(alphas: torch.Tensor, t_in: torch.Tensor,
                  done: torch.Tensor | None = None):
    """Sequential front-to-back weights of a block of alphas.

    alphas: (..., K, P) in front-to-back order (zeros = skipped);
    t_in: (..., P) incoming transmittance; done: (..., P) bool, pixels
    already stopped (default: none).

    Returns (weights (..., K, P), t_out (..., P), done_out (..., P)). The
    walk is entry by entry, in the same order of f32 operations as the CUDA
    kernel (csrc/rasterize_fwd.cu).
    """
    if done is None:
        done = torch.zeros_like(t_in, dtype=torch.bool)
    t = t_in
    weights = []
    zero = torch.zeros_like(t_in)
    for k in range(alphas.shape[-2]):
        a = alphas[..., k, :]
        t_after = t * (1.0 - a)
        done = done | (t_after < T_EPS)
        weights.append(torch.where(done, zero, a * t))
        t = torch.where(done, t, t_after)
    return torch.stack(weights, dim=-2), t, done
