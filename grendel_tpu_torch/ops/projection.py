"""Per-Gaussian preprocessing: project 3D Gaussians to screen space.

Counterpart of grendel_tpu/ops/projection.py: frustum cull, project means
through the full projection matrix, build the 2D covariance via the EWA
Jacobian, invert it to a conic, take a 3-sigma pixel radius, and evaluate
SH -> RGB along the view direction.

  * :func:`project_params` is the layer's one entry point: the raw
    parameters, activated and projected for a batch of cameras. On a CUDA
    tensor it runs :func:`project_cuda`; on a CPU tensor the plain version,
    ``models.gaussian_model.activated`` then :func:`project_gaussians_batched`.
  * :func:`project_gaussians` and :func:`project_gaussians_batched` are the
    plain version: dense elementwise torch over the (padded) Gaussian axis,
    differentiable by autograd.
  * :func:`project_cuda` launches ``csrc/projection.cu``: the activation,
    projection and SH of every (camera, Gaussian) pair in one kernel, and
    through its autograd Function the gradients of the raw parameters in
    one more (:func:`project_cuda_vjp`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..models.gaussian_model import GaussianParams, activated
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


def project_params(params: GaussianParams, alive: torch.Tensor, cams,
                   img_h: int, img_w: int, sh_degree: int) -> ProjectedSplats:
    """The projection layer: activate the raw ``params`` and project them
    for every camera of ``cams`` (a CameraArrays with a leading (B,) axis).
    Returns (B, N, ...) leaves, differentiable in the parameters.

    On a CUDA tensor it runs the kernel pair (:func:`project_cuda`); on a
    CPU tensor the plain version, which the CPU tests hold to the JAX
    package."""
    if params.means3d.device.type == "cpu":
        act = activated(params)
        return project_gaussians_batched(
            act.means3d, act.scales, act.quats, act.opacities, act.sh, alive,
            cams, img_h, img_w, sh_degree)
    return project_cuda(params, alive, cams, img_h, img_w, sh_degree)


# csrc/projection.cu evaluates SH up to degree 3 and stages a block's SH
# rows in shared memory sized for at most 16 coefficients a channel
MAX_SH_BASES = 16


def _kernel_inputs(params, alive, cams, sh_degree):
    """The raw leaves and cameras as the kernels take them: contiguous
    float32 on one CUDA device, ``sh_rest`` 16-byte aligned (its rows are
    copied as 16-byte vectors), ``alive`` bool (None for the backward,
    which reads the radii instead), the cameras (B, ...)."""
    dev = params.means3d.device
    if dev.type != "cuda":
        raise ValueError(f"no projection kernel for device {dev}")
    n = params.means3d.shape[0]
    leaves = [x.to(torch.float32).contiguous() for x in params]
    if leaves[2].data_ptr() % 16:
        leaves[2] = leaves[2].clone()
    k = leaves[2].shape[1] + 1 if leaves[2].dim() == 3 else 0
    want = GaussianParams(means3d=(n, 3), sh_dc=(n, 1, 3),
                          sh_rest=(n, k - 1, 3), scales_raw=(n, 3),
                          quats=(n, 4), opacities_raw=(n,))
    for name, x, shape in zip(GaussianParams._fields, leaves, want):
        if tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name} must be {shape} on {dev}, got "
                             f"{tuple(x.shape)} on {x.device}")
    if not 1 <= k <= MAX_SH_BASES or not 0 <= sh_degree <= 3 \
            or (sh_degree + 1) ** 2 > k:
        raise ValueError(f"SH degree {sh_degree} with {k} coefficients: the "
                         f"kernels take degree 0-3 within at most "
                         f"{MAX_SH_BASES}")
    if alive is not None and (alive.dtype != torch.bool
                              or alive.shape != (n,) or alive.device != dev):
        raise ValueError(f"alive must be ({n},) bool on {dev}")
    cams = [c.to(torch.float32).contiguous() for c in cams]
    b = cams[0].shape[0]
    for c, shape in zip(cams, ((b, 4, 4), (b, 4, 4), (b, 3), (b, 2))):
        if tuple(c.shape) != shape or c.device != dev:
            raise ValueError("cameras must be batched: viewmat, full_proj "
                             "(B,4,4), campos (B,3), tanfov (B,2) on "
                             f"{dev}, got {tuple(c.shape)} on {c.device}")
        if c.requires_grad:
            raise ValueError("the projection kernels take the cameras as "
                             "constants")
    return (GaussianParams(*leaves),
            None if alive is None else alive.contiguous(), cams)


def _ptrs(xs):
    return [x.data_ptr() for x in xs]


def _fwd(params: GaussianParams, alive, cams, img_h, img_w, sh_degree,
         scale_modifier) -> ProjectedSplats:
    """The forward kernel on checked inputs (:func:`_kernel_inputs`)."""
    n, b = params.means3d.shape[0], cams[0].shape[0]
    dev = params.means3d.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = ProjectedSplats(
        means2d=torch.empty(b, n, 2, **f32),
        conics=torch.empty(b, n, 3, **f32),
        colors=torch.empty(b, n, 3, **f32),
        opacities=torch.empty(b, n, **f32),
        depths=torch.empty(b, n, **f32),
        radii=torch.empty(b, n, dtype=torch.int32, device=dev))
    p = params
    lib = kernels.load("projection")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.check(lib.gts_project_fwd(
            *_ptrs((p.means3d, p.scales_raw, p.quats, p.opacities_raw,
                    p.sh_dc, p.sh_rest, alive)), *_ptrs(cams),
            n, b, p.sh_rest.shape[1], img_h, img_w, sh_degree,
            scale_modifier, *_ptrs(out), stream), "projection kernel")
    project_cuda.launches += 1
    return out


def _vjp(params: GaussianParams, cams, radii, img_h, img_w, sh_degree,
         scale_modifier, g_means2d, g_conics, g_colors,
         g_opacities) -> GaussianParams:
    """The backward kernel on checked inputs; a cotangent of None is
    zero."""
    n, b = params.means3d.shape[0], cams[0].shape[0]
    dev = params.means3d.device
    grads = GaussianParams(*(torch.empty_like(x) for x in params))
    cts = []
    for g, shape in zip((g_means2d, g_conics, g_colors, g_opacities),
                        ((b, n, 2), (b, n, 3), (b, n, 3), (b, n))):
        if g is not None:
            g = g.to(torch.float32).contiguous()
            if tuple(g.shape) != shape or g.device != dev:
                raise ValueError(f"cotangent must be {shape} on {dev}, got "
                                 f"{tuple(g.shape)} on {g.device}")
        cts.append(g)
    radii = radii.to(torch.int32).contiguous()
    if tuple(radii.shape) != (b, n) or radii.device != dev:
        raise ValueError(f"radii must be ({b}, {n}) on {dev}")
    p = params
    lib = kernels.load("projection")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.check(lib.gts_project_bwd(
            *_ptrs((p.means3d, p.scales_raw, p.quats, p.opacities_raw,
                    p.sh_dc, p.sh_rest)), *_ptrs(cams), radii.data_ptr(),
            *[0 if g is None else g.data_ptr() for g in cts],
            n, b, p.sh_rest.shape[1], img_h, img_w, sh_degree,
            scale_modifier,
            *_ptrs((grads.means3d, grads.scales_raw, grads.quats,
                    grads.opacities_raw, grads.sh_dc, grads.sh_rest)),
            stream), "projection backward kernel")
    project_cuda_vjp.launches += 1
    return grads


class _Project(torch.autograd.Function):
    """The projection with its backward, both kernels. Saves the checked
    inputs and the radii only: the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, means3d, sh_dc, sh_rest, scales_raw, quats,
                opacities_raw, alive, viewmat, full_proj, campos, tanfov,
                img_h, img_w, sh_degree, scale_modifier):
        params, alive, cams = _kernel_inputs(
            GaussianParams(means3d, sh_dc, sh_rest, scales_raw, quats,
                           opacities_raw), alive,
            (viewmat, full_proj, campos, tanfov), sh_degree)
        out = _fwd(params, alive, cams, img_h, img_w, sh_degree,
                   scale_modifier)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(out.depths, out.radii)
        ctx.save_for_backward(*params, *cams, out.radii)
        ctx.shape = (img_h, img_w, sh_degree, scale_modifier)
        return tuple(out)

    @staticmethod
    def backward(ctx, g_means2d, g_conics, g_colors, g_opacities, _g_depths,
                 _g_radii):
        *saved, radii = ctx.saved_tensors
        params, cams = GaussianParams(*saved[:6]), saved[6:]
        img_h, img_w, sh_degree, scale_modifier = ctx.shape
        grads = _vjp(params, cams, radii, img_h, img_w, sh_degree,
                     scale_modifier, g_means2d, g_conics, g_colors,
                     g_opacities)
        return (*grads,) + (None,) * 9


def project_cuda(params: GaussianParams, alive, cams, img_h: int, img_w: int,
                 sh_degree: int, scale_modifier: float = 1.0
                 ) -> ProjectedSplats:
    """The kernel pair of ``csrc/projection.cu`` on CUDA tensors: the
    splats of :func:`project_gaussians_batched` of the activated ``params``
    (B, N, ...), in one launch. Where a leaf requires grad the call goes
    through an autograd Function whose backward is one more launch
    (:func:`project_cuda_vjp`); ``depths`` and ``radii`` are not
    differentiable. The backward gives a pair whose radius is 0 no
    gradient: the render path sends it none (it is in no tile list and its
    opacity is 0)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in params):
        return ProjectedSplats(*_Project.apply(
            *params, alive, *cams, img_h, img_w, sh_degree,
            float(scale_modifier)))
    params, alive, cams = _kernel_inputs(params, alive, cams, sh_degree)
    return _fwd(params, alive, cams, img_h, img_w, sh_degree,
                float(scale_modifier))


def project_cuda_vjp(params: GaussianParams, cams, radii, img_h: int,
                     img_w: int, sh_degree: int, g_means2d=None,
                     g_conics=None, g_colors=None, g_opacities=None,
                     scale_modifier: float = 1.0) -> GaussianParams:
    """The projection's vector-Jacobian product on the card: the gradients
    of the raw leaves of ``params`` from the cotangents of the (B, N)
    splats' means2d, conics, colors and opacities (None for zero), summed
    over the cameras; pairs whose ``radii`` are 0 add nothing."""
    params, _, cams = _kernel_inputs(params, None, cams, sh_degree)
    return _vjp(params, cams, radii, img_h, img_w, sh_degree,
                float(scale_modifier), g_means2d, g_conics, g_colors,
                g_opacities)


project_cuda.launches = 0
project_cuda_vjp.launches = 0
