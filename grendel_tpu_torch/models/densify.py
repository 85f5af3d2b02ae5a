"""Densification, pruning and opacity reset on padded-capacity state.

Counterpart of grendel_tpu/models/densify.py. Per training step the
statistics accumulate the screen-space position-gradient norm of every
visible Gaussian (radii > 0), a visibility count and the largest screen
radius seen. On the densify schedule :func:`densify_and_prune` reads them:

  * clone: average gradient >= threshold and largest scale <= percent_dense
    * extent: the Gaussian is copied as it is into a free slot;
  * split: average gradient >= threshold and larger: two children drawn
    from the parent (position = parent + R @ (noise * scales), scales /
    1.6); child 1 overwrites the parent in place, child 2 takes a free
    slot;
  * prune: opacity < min_opacity and, after the first opacity reset,
    largest scale > 0.1 * extent.

Everything stays at a fixed capacity: pruned slots become free, new
Gaussians go into free slots by rank (clones first, then split child 2s),
and a new Gaussian whose rank is past the last free slot is dropped and
counted, so the host can grow the capacity. :func:`reset_opacity` clamps
opacities to at most 0.01 and zeroes their Adam moments.

The split noise is an argument: the JAX package draws it with
``jax.random.normal(key, (n, 2, 3))``, and the caller passes a
standard-normal draw of that shape (the trainers the same draw, from
utils/prng.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..utils.math3d import inverse_sigmoid, quat_rotmat_entries
from .gaussian_model import GaussianParams
from .optimizer import AdamState

SPLIT_N = 2                      # children per split
SPLIT_SCALE_DIV = 0.8 * SPLIT_N  # children's scale divisor (1.6)
WS_PRUNE_COEFF = 0.1             # world-size prune: scale > 0.1 * extent


class DensifyStats(NamedTuple):
    grad_accum: torch.Tensor   # (N,) accumulated screen-space grad norms
    denom: torch.Tensor        # (N,) visibility count
    max_radii: torch.Tensor    # (N,) max screen radius seen


class DensifyInfo(NamedTuple):
    """What one densify pass did; :func:`densify_and_prune` returns these
    five counts as one (5,) int32 tensor in this order, so the host reads
    them back with one transfer (``DensifyInfo(*info.tolist())``)."""

    n_cloned: int
    n_split: int
    n_pruned: int
    n_dropped: int      # new Gaussians that did not fit in the capacity
    n_alive: int


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


def _rows(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``mask`` (N,) broadcast over the trailing axes of ``leaf``."""
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1))


def densify_and_prune(
    params: GaussianParams,
    alive: torch.Tensor,
    adam: AdamState,
    stats: DensifyStats,
    noise: torch.Tensor,          # (N, SPLIT_N, 3) standard normal
    grad_threshold: float,
    min_opacity: float,
    extent: float,
    percent_dense: float,
    use_size_prune: bool,
) -> Tuple[GaussianParams, torch.Tensor, AdamState, DensifyStats,
           torch.Tensor]:
    """One densify/prune pass. Returns (params, alive, adam, fresh stats,
    info (5,) int32 in :class:`DensifyInfo` order). Reads nothing back to
    the host."""
    n = alive.shape[0]
    if noise.shape != (n, SPLIT_N, 3):
        raise ValueError(f"noise must be ({n}, {SPLIT_N}, 3), got "
                         f"{tuple(noise.shape)}")
    grads = torch.where(stats.denom > 0, stats.grad_accum / stats.denom,
                        torch.zeros_like(stats.denom))
    opac = torch.sigmoid(params.opacities_raw)
    scales = torch.exp(params.scales_raw)
    max_scale = torch.amax(scales, dim=-1)

    keep = alive & (opac >= min_opacity)
    if use_size_prune:
        keep = keep & ~(max_scale > WS_PRUNE_COEFF * extent)
    n_pruned = alive.sum() - keep.sum()

    grad_cond = grads >= grad_threshold
    big = max_scale > percent_dense * extent
    clone_mask = keep & grad_cond & ~big
    split_mask = keep & grad_cond & big
    n_clones = clone_mask.sum()
    n_splits = split_mask.sum()
    n_free = n - keep.sum()

    # free slots first, in index order: a stable sort of alive
    free_order = torch.argsort(keep.to(torch.uint8), stable=True)
    # new items are ranked clones first, then split child 2s
    clone_rank = torch.cumsum(clone_mask, 0) - 1
    child2_rank = n_clones + torch.cumsum(split_mask, 0) - 1

    def dst_for(mask, rank):
        """Destination slot of each Gaussian's new item, or n where it has
        none or its rank is past the last free slot (dropped)."""
        ok = mask & (rank < n_free)
        slot = free_order[rank.clamp(0, n - 1)]
        return torch.where(ok, slot, torch.full_like(slot, n))

    dst_clone = dst_for(clone_mask, clone_rank)
    dst_child2 = dst_for(split_mask, child2_rank)
    n_dropped = (n_clones + n_splits) - ((dst_clone < n).sum()
                                         + (dst_child2 < n).sum())

    def scatter(leaf, src_clone, src_child2):
        """Write the new items into their slots. Index n is a spare row
        that takes every non-item and is cut off, so nothing is read back
        to the host (the valid destinations are distinct)."""
        ext = torch.cat([leaf, leaf[:1]])
        ext[dst_clone] = src_clone
        ext[dst_child2] = src_child2
        return ext[:n]

    # split children: position drawn from the parent Gaussian, scale / 1.6;
    # the rotation in component form, in the JAX package's order of terms
    samples = noise * scales[:, None, :]
    r = quat_rotmat_entries(params.quats)
    s0, s1, s2 = samples[..., 0], samples[..., 1], samples[..., 2]
    offsets = torch.stack([
        r[0][:, None] * s0 + r[1][:, None] * s1 + r[2][:, None] * s2,
        r[3][:, None] * s0 + r[4][:, None] * s1 + r[5][:, None] * s2,
        r[6][:, None] * s0 + r[7][:, None] * s1 + r[8][:, None] * s2,
    ], dim=-1)                                            # (n, SPLIT_N, 3)
    child_xyz = params.means3d[:, None, :] + offsets
    child_scales_raw = params.scales_raw - math.log(SPLIT_SCALE_DIV)
    child1 = params._replace(means3d=child_xyz[:, 0],
                             scales_raw=child_scales_raw)
    child2 = params._replace(means3d=child_xyz[:, 1],
                             scales_raw=child_scales_raw)

    # child 1 overwrites its parent in place; clones (parent values) and
    # child 2s go to their free slots
    out = GaussianParams(*(
        scatter(torch.where(_rows(split_mask, old), c1, old), old, c2)
        for old, c1, c2 in zip(params, child1, child2)))
    true = torch.ones_like(keep)
    alive_new = scatter(keep, true, true)

    # Adam moments of split parents (now child 1) and of every filled slot
    # start from zero
    def zero_moments(leaf):
        zeros = torch.zeros_like(leaf)
        return scatter(torch.where(_rows(split_mask, leaf), zeros, leaf),
                       zeros, zeros)

    adam_new = AdamState(
        mu=GaussianParams(*(zero_moments(m) for m in adam.mu)),
        nu=GaussianParams(*(zero_moments(v) for v in adam.nu)),
        count=adam.count)
    info = torch.stack([n_clones, n_splits, n_pruned, n_dropped,
                        alive_new.sum()]).to(torch.int32)
    # the statistics start over after every densification
    return (out, alive_new, adam_new, densify_stats_init(n, alive.device),
            info)


def reset_opacity(params: GaussianParams, adam: AdamState,
                  ceiling: float = 0.01) -> Tuple[GaussianParams, AdamState]:
    """Clamp opacity to <= ceiling and zero its Adam moments."""
    opac = torch.sigmoid(params.opacities_raw)
    new_raw = inverse_sigmoid(torch.clamp(opac, max=ceiling))
    adam_new = AdamState(
        mu=adam.mu._replace(
            opacities_raw=torch.zeros_like(adam.mu.opacities_raw)),
        nu=adam.nu._replace(
            opacities_raw=torch.zeros_like(adam.nu.opacities_raw)),
        count=adam.count)
    return params._replace(opacities_raw=new_raw), adam_new
