"""Plain densification: 3DGS's statistics, and its clone, split and prune
rule applied to one state.

Each training step adds, for every Gaussian a camera sees (radius > 0),
the norm of the loss's gradient with respect to its projected centre,
scaled from pixels to half extents (x 0.5 W, x 0.5 H), and counts the
view; the largest radius seen is kept. A densify round then reads the
average gradient:

  * prune: opacity under ``min_opacity`` (and, after the first opacity
    reset, largest scale over 0.1 x extent);
  * clone: a kept Gaussian with average gradient at or over the threshold
    and largest scale at or under ``percent_dense`` x extent is copied;
  * split: a larger one is replaced by two children, each at the parent's
    centre plus its rotation times the scales times a standard normal,
    with the scales divided by 1.6.

New Gaussians (clones and children) start with zero Adam moments; kept
ones keep theirs. The split's standard normals are JAX's
``jax.random.normal(key(seed), (slots, 2, 3))``, the draw the training
loop names for the round (threefry2x32 counters, the float32 uniform on
[-1, 1) through the inverse error function): row ``i`` of the draw is the
Gaussian in slot ``i``.

The result is the multiset of the live Gaussians' rows; where they sit in
the program's slots is the program's own affair.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .render import quat_to_rot

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
SPLIT_SCALE_DIV = 1.6
SIZE_PRUNE = 0.1
LEAVES = ("means3d", "sh_dc", "sh_rest", "scales_raw", "quats",
          "opacities_raw")


def _threefry2x32(k0: int, k1: int, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def jax_normal(seed: int, shape, device) -> torch.Tensor:
    """``jax.random.normal(jax.random.key(seed), shape)``, float32."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = _threefry2x32((seed >> 32) & MASK, seed & MASK, idx >> 32,
                           idx & MASK)
    bits = b0 ^ b1
    unit = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = np.float32(np.nextafter(np.float32(-1), np.float32(0)))
    u = ((unit - 1.0).double() * float(np.float32(1) - lo)
         + float(lo)).float().clamp(min=float(lo))
    return (torch.erfinv(u) * float(np.float32(math.sqrt(2)))).reshape(
        tuple(shape))


def accumulate(stats, means2d_grad, radius, w: int, h: int):
    """``stats`` (grad_accum, denom, max_radii) after one camera's view:
    ``means2d_grad`` (N, 2) in pixels, ``radius`` (N,)."""
    seen = radius > 0
    norm = torch.linalg.vector_norm(
        means2d_grad.float() * torch.tensor([0.5 * w, 0.5 * h],
                                            device=means2d_grad.device), dim=-1)
    g, d, r = stats
    return (g + torch.where(seen, norm, torch.zeros_like(norm)),
            d + seen.float(), torch.maximum(r, radius.float()))


class Round(NamedTuple):
    rows: dict        # leaf -> (M, ...) live rows: params, "m.*", "v.*"
    clone: int
    split: int
    prune: int
    alive: int


def densify(params: dict, alive, adam_m: dict, adam_v: dict, stats,
            noise, grad_threshold: float, min_opacity: float, extent: float,
            percent_dense: float, size_prune: bool,
            dtype=torch.float32) -> Round:
    """One round on a state of slots (``alive`` marks the live ones)."""
    p = {k: params[k].to(dtype) for k in LEAVES}
    accum, denom = stats[0].to(dtype), stats[1].to(dtype)
    grads = torch.where(denom > 0, accum / denom, torch.zeros_like(denom))
    scales = torch.exp(p["scales_raw"])
    largest = scales.amax(-1)
    keep = alive & (torch.sigmoid(p["opacities_raw"]) >= min_opacity)
    if size_prune:
        keep = keep & ~(largest > SIZE_PRUNE * extent)
    dense = keep & (grads >= grad_threshold)
    clone = dense & ~(largest > percent_dense * extent)
    split = dense & (largest > percent_dense * extent)
    z = noise[split].to(dtype) * scales[split][:, None, :]      # (S, 2, 3)
    rot = quat_to_rot(p["quats"][split])                         # (S, 3, 3)
    centres = (p["means3d"][split][:, None, :]
               + torch.einsum("sij,scj->sci", rot, z)).reshape(-1, 3)
    rows = {}
    for k in LEAVES:
        t = p[k]
        child = t[split].repeat_interleave(2, 0)
        if k == "means3d":
            child = centres
        elif k == "scales_raw":
            child = child - math.log(SPLIT_SCALE_DIV)
        rows[k] = torch.cat([t[keep & ~split], t[clone], child])
        for tag, mom in (("m", adam_m), ("v", adam_v)):
            old = mom[k].to(dtype)[keep & ~split]
            new = old.new_zeros((int(clone.sum()) + 2 * int(split.sum()),)
                                + old.shape[1:])
            rows[f"{tag}.{k}"] = torch.cat([old, new])
    n_clone, n_split = int(clone.sum()), int(split.sum())
    return Round(rows, n_clone, n_split, int((alive & ~keep).sum()),
                 int(keep.sum()) + n_clone + n_split)


def rows_of(params: dict, alive, adam_m: dict, adam_v: dict) -> dict:
    """A state's live rows, keyed as :class:`Round`'s."""
    rows = {k: params[k][alive] for k in LEAVES}
    for tag, mom in (("m", adam_m), ("v", adam_v)):
        rows.update({f"{tag}.{k}": mom[k][alive] for k in LEAVES})
    return rows
