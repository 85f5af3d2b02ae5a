"""Densification statistics on padded-capacity state.

Counterpart of the statistics half of grendel_tpu/models/densify.py: per
training step, accumulate the screen-space position-gradient norm of every
visible Gaussian (radii > 0), a visibility count, and the largest screen
radius seen. ``densify_and_prune`` and ``reset_opacity``, which read these
statistics on the densify schedule, belong to the host training loop and
are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DensifyStats(NamedTuple):
    grad_accum: torch.Tensor   # (N,) accumulated screen-space grad norms
    denom: torch.Tensor        # (N,) visibility count
    max_radii: torch.Tensor    # (N,) max screen radius seen


def densify_stats_init(capacity: int, device) -> DensifyStats:
    def z():
        return torch.zeros(capacity, dtype=torch.float32, device=device)
    return DensifyStats(grad_accum=z(), denom=z(), max_radii=z())


def accumulate_densify_stats(
    stats: DensifyStats,
    means2d_grad: torch.Tensor,   # (B, N, 2) d(loss)/d(means2d), pixel space
    radii: torch.Tensor,          # (B, N) int32, 0 = not visible
    img_w: int,
    img_h: int,
) -> DensifyStats:
    """Add one batch's screen-space gradient statistics.

    The projected means are in pixels; the default densify threshold
    (0.0002) assumes gradients in NDC half-extent units, so the pixel
    gradients are scaled by (0.5 W, 0.5 H) before the norm, as the
    reference does for its gsplat path."""
    visible = radii > 0                                       # (B, N)
    scale = torch.tensor([0.5 * img_w, 0.5 * img_h], dtype=torch.float32,
                         device=means2d_grad.device)
    norms = torch.linalg.vector_norm(means2d_grad * scale, dim=-1)
    return DensifyStats(
        grad_accum=stats.grad_accum + torch.sum(
            torch.where(visible, norms, torch.zeros_like(norms)), dim=0),
        denom=stats.denom + torch.sum(visible, dim=0).to(torch.float32),
        max_radii=torch.maximum(stats.max_radii,
                                torch.amax(radii, dim=0).to(torch.float32)),
    )
