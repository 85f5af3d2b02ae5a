"""Per-Gaussian preprocessing: project 3D Gaussians to screen space.

Counterpart of grendel_tpu/ops/projection.py: frustum cull, project means
through the full projection matrix, build the 2D covariance via the EWA
Jacobian, invert it to a conic, take a 3-sigma pixel radius, and evaluate
SH -> RGB along the view direction. Dense elementwise torch over the
(padded) Gaussian axis; no kernel. Differentiable by autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.math3d import quat_rotmat_entries
from .sh import sh_to_rgb

# Low-pass filter added to the 2D covariance diagonal (EWA antialias floor).
COV2D_DILATION = 0.3
# Minimum view-space depth for frustum inclusion.
NEAR_CULL = 0.2


class ProjectedSplats(NamedTuple):
    """Screen-space Gaussians for one camera, or (B, N, ...) for a batch."""

    means2d: torch.Tensor     # (N, 2) pixel coords
    conics: torch.Tensor      # (N, 3) inverse 2D covariance (a, b, c)
    colors: torch.Tensor      # (N, 3) RGB in [0, inf)
    opacities: torch.Tensor   # (N,)
    depths: torch.Tensor      # (N,) view-space z, +inf when culled
    radii: torch.Tensor       # (N,) int32 pixel radius (0 => culled)


def _view_cov2d_terms(scales, quats, viewmat):
    """The six unique entries of V = W (R S S^T R^T) W^T as (N,) tensors,
    with u_j = W @ (column j of R): V = sum_j s_j^2 u_j u_j^T."""
    r = quat_rotmat_entries(quats)
    w = viewmat[:3, :3]
    s2 = scales * scales
    v00 = v01 = v02 = v11 = v12 = v22 = 0.0
    for j in range(3):
        rj = (r[0 + j], r[3 + j], r[6 + j])
        u0 = w[0, 0] * rj[0] + w[0, 1] * rj[1] + w[0, 2] * rj[2]
        u1 = w[1, 0] * rj[0] + w[1, 1] * rj[1] + w[1, 2] * rj[2]
        u2 = w[2, 0] * rj[0] + w[2, 1] * rj[1] + w[2, 2] * rj[2]
        sj = s2[:, j]
        v00 = v00 + sj * u0 * u0
        v01 = v01 + sj * u0 * u1
        v02 = v02 + sj * u0 * u2
        v11 = v11 + sj * u1 * u1
        v12 = v12 + sj * u1 * u2
        v22 = v22 + sj * u2 * u2
    return v00, v01, v02, v11, v12, v22


def project_gaussians(
    means3d: torch.Tensor,     # (N,3)
    scales: torch.Tensor,      # (N,3) activated (exp'd)
    quats: torch.Tensor,       # (N,4) unnormalized
    opacities: torch.Tensor,   # (N,) activated (sigmoid'd)
    sh: torch.Tensor,          # (N,K,3) full SH coeffs (dc at 0)
    alive: torch.Tensor,       # (N,) bool
    viewmat: torch.Tensor,     # (4,4)
    full_proj: torch.Tensor,   # (4,4)
    campos: torch.Tensor,      # (3,)
    tanfov: torch.Tensor,      # (2,) [tanfovx, tanfovy]
    img_h: int,
    img_w: int,
    sh_degree: int,
    scale_modifier: float = 1.0,
) -> ProjectedSplats:
    """Project one camera's view of the Gaussians.

    Culled or dead Gaussians get radii=0, opacity=0 and depth=+inf, so
    downstream stages can use radii > 0 as the visibility predicate.
    """
    means3d = means3d.to(torch.float32)

    # view transform & frustum cull
    p_view = means3d @ viewmat[:3, :3].T + viewmat[:3, 3]
    depth = p_view[:, 2]
    in_front = depth > NEAR_CULL

    # screen-space mean via the full projection
    p_hom = means3d @ full_proj[:3, :3].T + full_proj[:3, 3]
    w_hom = means3d @ full_proj[3, :3] + full_proj[3, 3]
    rw = 1.0 / (w_hom + 1e-7)
    ndc = p_hom[:, :2] * rw[:, None]
    mean2d = torch.stack([((ndc[:, 0] + 1.0) * img_w - 1.0) * 0.5,
                          ((ndc[:, 1] + 1.0) * img_h - 1.0) * 0.5], dim=-1)

    # 2D covariance via the EWA Jacobian
    tanfovx, tanfovy = tanfov[0], tanfov[1]
    focal_x = img_w / (2.0 * tanfovx)
    focal_y = img_h / (2.0 * tanfovy)
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    safe_z = torch.where(in_front, depth, torch.ones_like(depth))
    txz = p_view[:, 0] / safe_z
    tyz = p_view[:, 1] / safe_z
    tx = torch.minimum(torch.maximum(txz, -limx), limx) * safe_z
    ty = torch.minimum(torch.maximum(tyz, -limy), limy) * safe_z

    inv_z = 1.0 / safe_z
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2

    v00, v01, v02, v11, v12, v22 = _view_cov2d_terms(
        scales * scale_modifier, quats, viewmat)

    # J V J^T restricted to 2x2, expanded with the sparse J structure
    c00 = j00 * (j00 * v00 + j02 * v02) + j02 * (j00 * v02 + j02 * v22)
    c01 = j00 * (j11 * v01 + j12 * v02) + j02 * (j11 * v12 + j12 * v22)
    c11 = j11 * (j11 * v11 + j12 * v12) + j12 * (j11 * v12 + j12 * v22)
    c00 = c00 + COV2D_DILATION
    c11 = c11 + COV2D_DILATION

    det = c00 * c11 - c01 * c01
    det_ok = det > 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = 1.0 / safe_det
    conic = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det], -1)

    # 3-sigma radius from the largest eigenvalue of the 2x2 covariance
    mid = 0.5 * (c00 + c11)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - safe_det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam1))

    # does the 3-sigma box overlap the image at all?
    on_screen = ((mean2d[:, 0] + radius_f > 0)
                 & (mean2d[:, 0] - radius_f < img_w)
                 & (mean2d[:, 1] + radius_f > 0)
                 & (mean2d[:, 1] - radius_f < img_h))

    visible = in_front & det_ok & on_screen & alive
    radii = torch.where(visible, radius_f, torch.zeros_like(radius_f))

    # SH -> RGB along the view direction
    dirs = means3d - campos
    dirs = dirs / (torch.sqrt(torch.sum(dirs * dirs, -1, keepdim=True)) + 1e-12)
    colors = sh_to_rgb(sh_degree, sh, dirs)

    return ProjectedSplats(
        means2d=mean2d,
        conics=conic,
        colors=colors,
        opacities=torch.where(visible, opacities, torch.zeros_like(opacities)),
        depths=torch.where(visible, depth, torch.full_like(depth, float("inf"))),
        radii=radii.to(torch.int32),
    )


def project_gaussians_batched(means3d, scales, quats, opacities, sh, alive,
                              cams, img_h: int, img_w: int,
                              sh_degree: int) -> ProjectedSplats:
    """Project for every camera of a batched CameraArrays: (B, N, ...) leaves."""
    per_cam = [
        project_gaussians(means3d, scales, quats, opacities, sh, alive,
                          vm, fp, cp, tf, img_h, img_w, sh_degree)
        for vm, fp, cp, tf in zip(cams.viewmat, cams.full_proj, cams.campos,
                                  cams.tanfov)
    ]
    return ProjectedSplats(*(torch.stack(x) for x in zip(*per_cam)))
