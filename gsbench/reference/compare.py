"""The numbers that decide ``correct``, each a gap between what the timed
path produced and what the reference computes from the same inputs."""

from __future__ import annotations

import statistics

import torch

# a leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone, and is not compared
QUIET_LEAF = 1e-3


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def train_numbers(losses, grads1: dict, params3: dict, ref, p0: dict) -> dict:
    """Training: the worst step's loss gap over the reference's loss; per
    leaf, the gap between the norms of the first gradient (as the
    optimizer received it) and between the norms of the parameters' change
    after the steps, each over the larger of the reference's norm of that
    leaf and of the median leaf. Leaves with a quiet reference gradient
    are left out of both."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref.losses))
    g_ref = {k: _norm(v) for k, v in ref.grads1.items()}
    g_med = statistics.median(g_ref.values())
    leaves = [k for k, v in g_ref.items() if v >= QUIET_LEAF * g_med]
    d_ref = {k: _norm(ref.params[k].to(p0[k].device) - p0[k])
             for k in leaves}
    d_med = statistics.median(d_ref.values())
    grad_gap = max(abs(_norm(grads1[k]) - g_ref[k]) / max(g_ref[k], g_med)
                   for k in leaves)
    change_gap = max(abs(_norm(params3[k] - p0[k]) - d_ref[k])
                     / max(d_ref[k], d_med) for k in leaves)
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap,
            "change_norm_gap": change_gap}


def stats_numbers(stats, ref_stats) -> dict:
    """The densify statistics after the first steps, (accumulated gradient
    norms, view counts, largest radii): the norm of the difference of the
    accumulated norms over the reference's norm, and the share of the
    Gaussians whose view count or largest radius differs (a radius that
    rounds the other way at a pixel's edge moves both)."""
    a, b = [x.cpu() for x in stats], [x.cpu() for x in ref_stats]
    grad = _norm(a[0] - b[0]) / max(_norm(b[0]), 1e-30)
    views = ((a[1] != b[1]) | (a[2] != b[2])).double().mean()
    return {"stats_grad_gap": grad, "stats_view_mismatch": float(views)}


def densify_numbers(rows: dict, counts, ref) -> dict:
    """A densify round: ``counts`` the program's (clone, split, prune,
    dropped) and its live Gaussians after the round, ``rows`` its live
    rows then, ``ref`` the reference's Round. The count gap sums the
    differences of the counts and the new Gaussians the program dropped;
    the row gap is, over every leaf
    and column, the largest difference between the sorted values of the
    live rows over the reference's largest magnitude in that leaf: the
    rows compared as a multiset, wherever the slots put them."""
    clone, split, prune, dropped, alive = (int(x) for x in counts)
    count_gap = (abs(clone - ref.clone) + abs(split - ref.split)
                 + abs(prune - ref.prune) + abs(alive - ref.alive) + dropped)
    row_gap = 0.0
    for k, r in ref.rows.items():
        a = rows[k].to(r.device, torch.float32).reshape(rows[k].shape[0], -1)
        b = r.float().reshape(r.shape[0], -1)
        if a.shape != b.shape:
            return {"densify_count_gap": float(max(count_gap, 1)),
                    "densify_row_gap": float("inf")}
        d = (a.sort(0).values - b.sort(0).values).abs().max()
        top = b.abs().max()
        row_gap = max(row_gap, float(d / max(float(top),
                                             torch.finfo(torch.float32).tiny)))
    return {"densify_count_gap": float(count_gap), "densify_row_gap": row_gap}


def frame_numbers(frames, ref_frames, counts, ref_counts, radii,
                  ref_radii) -> dict:
    """Rendering: over the sampled frames, the largest pixel error and the
    largest mean pixel error, the share of tiles whose entry count differs
    and the share of Gaussians whose pixel radius differs."""
    max_err = mean_err = tiles = radius = 0.0
    for f, r, c, rc, ra, rr in zip(frames, ref_frames, counts, ref_counts,
                                   radii, ref_radii):
        d = (f.float() - r.float().to(f.device)).abs()
        max_err = max(max_err, float(d.max()))
        mean_err = max(mean_err, float(d.double().mean()))
        tiles = max(tiles, float((c.long().cpu() != rc.long().cpu())
                                 .double().mean()))
        radius = max(radius, float((ra.long().cpu() != rr.long().cpu())
                                   .double().mean()))
    return {"frame_max_err": max_err, "frame_mean_err": mean_err,
            "tile_count_mismatch": tiles, "radius_mismatch": radius}


def judge(numbers: dict, limits: dict):
    """(correct, [(name, number, limit)]): every number at or under its
    limit, and every limit read."""
    rows = [(k, numbers.get(k), limits[k]) for k in sorted(limits)]
    ok = all(v is not None and v == v and v <= lim for _, v, lim in rows)
    return ok, rows
