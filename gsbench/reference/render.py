"""Plain 3D Gaussian Splatting forward and backward in PyTorch.

The yardstick's reference. It imports nothing of the program. It follows
the 3DGS rasterizer (Kerbl et al. 2023) as this system states it:

  * activations: exp scales, sigmoid opacity, normalized quaternions;
  * projection: EWA covariance J W Sigma W^T J^T plus 0.3 on the diagonal,
    culled at view depth 0.2, a 3-sigma integer pixel radius from the
    larger eigenvalue, the mean through the full projection matrix;
  * colour: real spherical harmonics to the step's degree, +0.5, >= 0;
  * tile lists: each visible Gaussian covers the tiles of its box of
    half-width min(radius, the opacity-aware radius beyond which alpha is
    provably under 1/255), less, in frames up to 2,048 pixels a side, the
    tiles that circle does not reach; a tile walks at most
    ``max_per_tile`` of its Gaussians in depth order (ties by index);
  * blend: alpha = min(0.99, o exp(power)), skipped where power > 0 or
    alpha < 1/255; a pixel stops at the first entry that would bring its
    transmittance under 1e-4, and that entry is not blended.

The walk is vectorised over padded blocks of tiles. A cumulative product
replaces the kernel's running product, so the two round differently. The
backward runs autograd over the same blocks again, one block at a time,
so the whole frame's graph is never held at once.

Every function takes a ``dtype``: float32 is the reference, and the
control computes the very same in bfloat16.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEAR = 0.2
DILATION = 0.3
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
# frames up to this many pixels a side also take the corner cull
CULL_MAX = 2048
# padded (tile, entry, pixel) elements a block of the walk may hold
BLOCK_ELEMS = 1 << 26

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class Camera(NamedTuple):
    """One camera as four tensors: world-to-view (4, 4), full projection
    (4, 4), centre (3,), and tan of the half field of view (x, y)."""

    viewmat: torch.Tensor
    full_proj: torch.Tensor
    campos: torch.Tensor
    tanfov: torch.Tensor


class Splats(NamedTuple):
    means2d: torch.Tensor    # (N, 2)
    conic: torch.Tensor      # (N, 3)
    color: torch.Tensor      # (N, 3)
    opacity: torch.Tensor    # (N,) zero where not visible
    depth: torch.Tensor      # (N,)
    radius: torch.Tensor     # (N,) int64, 0 where not visible


class TileLists(NamedTuple):
    gid: torch.Tensor        # (E,) Gaussian of each entry, tile-major
    offsets: torch.Tensor    # (T + 1,) entry span of each tile
    counts: torch.Tensor     # (T,) entries of each tile, before the cap


def eval_sh(degree: int, sh, dirs):
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    out = SH_C0 * sh[:, 0]
    if degree >= 1:
        out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] \
            - SH_C1 * x * sh[:, 3]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out = (out + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
               + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
               + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree >= 3:
        out = (out + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
               + SH_C3[1] * xy * z * sh[:, 10]
               + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14]
               + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return out


def quat_to_rot(q):
    q = q / q.norm(dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def project(params: dict, alive, cam: Camera, h: int, w: int,
            sh_degree: int, dtype=torch.float32) -> Splats:
    """Project the Gaussians of ``params`` (raw leaves: means3d, sh_dc,
    sh_rest, scales_raw, quats, opacities_raw) for one camera."""
    p = {k: v.to(dtype) for k, v in params.items()}
    vm, fp, cpos, tanfov = (x.to(dtype) for x in cam)
    means = p["means3d"]
    scales = torch.exp(p["scales_raw"])
    opac = torch.sigmoid(p["opacities_raw"])
    sh = torch.cat([p["sh_dc"], p["sh_rest"]], 1)

    pv = means @ vm[:3, :3].T + vm[:3, 3]
    z = pv[:, 2]
    front = z > NEAR
    zs = torch.where(front, z, torch.ones_like(z))
    hom = means @ fp[:3, :3].T + fp[:3, 3]
    wh = means @ fp[3, :3] + fp[3, 3]
    ndc = hom[:, :2] / (wh + 1e-7)[:, None]
    m2d = torch.stack([((ndc[:, 0] + 1) * w - 1) / 2,
                       ((ndc[:, 1] + 1) * h - 1) / 2], -1)

    fx, fy = w / (2 * tanfov[0]), h / (2 * tanfov[1])
    limx, limy = 1.3 * tanfov[0], 1.3 * tanfov[1]
    tx = (pv[:, 0] / zs).clamp(-limx, limx) * zs
    ty = (pv[:, 1] / zs).clamp(-limy, limy) * zs
    zero = torch.zeros_like(zs)
    jac = torch.stack([fx / zs, zero, -fx * tx / (zs * zs),
                       zero, fy / zs, -fy * ty / (zs * zs)], -1).reshape(-1, 2, 3)
    rot = quat_to_rot(p["quats"])
    m = rot * scales[:, None, :]                  # R S
    sigma = m @ m.transpose(1, 2)                 # R S S^T R^T
    t = jac @ vm[:3, :3]                          # J W
    cov = t @ sigma @ t.transpose(1, 2)
    a = cov[:, 0, 0] + DILATION
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + DILATION
    det = a * c - b * b
    det_ok = det > 0
    det_s = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c / det_s, -b / det_s, a / det_s], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det_s, min=0.1))
    rad = torch.ceil(3 * torch.sqrt(lam))
    on = ((m2d[:, 0] + rad > 0) & (m2d[:, 0] - rad < w)
          & (m2d[:, 1] + rad > 0) & (m2d[:, 1] - rad < h))
    vis = front & det_ok & on & alive
    dirs = means - cpos
    dirs = dirs / (dirs.norm(dim=-1, keepdim=True) + 1e-12)
    color = torch.clamp(eval_sh(sh_degree, sh, dirs) + 0.5, min=0.0)
    return Splats(
        means2d=m2d, conic=conic, color=color,
        opacity=torch.where(vis, opac, torch.zeros_like(opac)),
        depth=torch.where(vis, z, torch.full_like(z, float("inf"))),
        radius=torch.where(vis, rad.detach(),
                           torch.zeros_like(rad)).to(torch.int64))


def _boxes(s: Splats, h: int, w: int, tile_w: int, tile_h: int):
    """Each Gaussian's box of tiles (x0, y0, width, height; empty where it
    is not visible), its opacity-aware radius and its mean, in float32
    whatever the splats' type."""
    tiles_x, tiles_y = -(-w // tile_w), -(-h // tile_h)
    m2d = s.means2d.detach().float()
    r = s.radius.float()
    op = s.opacity.detach().float()
    ln = torch.log(torch.clamp(255.0 * op, min=1e-30))
    rc = (r / 3.0) * torch.sqrt(2.0 * torch.clamp(ln, min=0.0)) * 1.0001
    keep = (s.radius > 0) & (ln > 0)
    rr = torch.minimum(rc, r)
    mx, my = m2d[:, 0], m2d[:, 1]
    x0 = torch.clamp(torch.floor((mx - rr) / tile_w), 0, tiles_x)
    y0 = torch.clamp(torch.floor((my - rr) / tile_h), 0, tiles_y)
    x1 = torch.clamp(torch.minimum(torch.floor((mx + rr) / tile_w) + 1,
                                   torch.floor((mx + r + tile_w - 1) / tile_w)),
                     0, tiles_x)
    y1 = torch.clamp(torch.minimum(torch.floor((my + rr) / tile_h) + 1,
                                   torch.floor((my + r + tile_h - 1) / tile_h)),
                     0, tiles_y)
    sx = torch.where(keep, x1 - x0, torch.zeros_like(x0)).long()
    sy = torch.where(keep, y1 - y0, torch.zeros_like(y0)).long()
    return x0, y0, sx, sy, rc, mx, my


def entry_demand(s: Splats, h: int, w: int, tile_w: int, tile_h: int) -> int:
    """Entries the boxes ask for, before the corner cull: the count a
    program's entry capacity is sized by."""
    _, _, sx, sy, *_ = _boxes(s, h, w, tile_w, tile_h)
    return int((sx * sy).sum())


def tile_lists(s: Splats, h: int, w: int, tile_w: int, tile_h: int
               ) -> TileLists:
    """Each tile's Gaussians in depth order (the box rule of the module's
    docstring)."""
    tiles_x, tiles_y = -(-w // tile_w), -(-h // tile_h)
    x0, y0, sx, sy, rc, mx, my = _boxes(s, h, w, tile_w, tile_h)
    n = sx * sy
    g = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n)
    start = torch.cumsum(n, 0) - n
    k = torch.arange(g.numel(), device=n.device) - start[g]
    tx = x0.long()[g] + k % sx[g]
    ty = y0.long()[g] + torch.div(k, sx[g], rounding_mode="floor")
    if tiles_x * tile_w <= CULL_MAX and tiles_y * tile_h <= CULL_MAX:
        keep_e = _corner_reaches(mx[g], my[g], rc[g], tx, ty, tile_w, tile_h)
        g, tx, ty = g[keep_e], tx[keep_e], ty[keep_e]
    tile = ty * tiles_x + tx
    # depth rank, ties by index: the sort key of an entry is (tile, rank)
    rank = torch.empty_like(s.depth, dtype=torch.int64)
    rank[torch.sort(s.depth.detach().float(), stable=True).indices] = \
        torch.arange(rank.numel(), device=rank.device)
    order = torch.sort(tile * rank.numel() + rank[g]).indices
    counts = torch.bincount(tile, minlength=tiles_x * tiles_y)
    offsets = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                          device=counts.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return TileLists(gid=g[order], offsets=offsets, counts=counts)


def _corner_reaches(mx, my, rc, tx, ty, tile_w: int, tile_h: int):
    """The corner cull of frames up to 2,048 pixels a side: an entry stays
    where the circle of the opacity-aware radius, on the mean rounded to a
    pixel and the radius rounded up to 2 pixels, plus 2 pixels of slack,
    reaches the tile. Means off the frame keep every entry."""
    mxq, myq = torch.round(mx).long(), torch.round(my).long()
    inb = (mxq >= 0) & (mxq < CULL_MAX) & (myq >= 0) & (myq < CULL_MAX)
    rq = torch.where(inb, torch.clamp(torch.ceil(rc * 0.5), max=511).long(),
                     torch.full_like(mxq, 511))
    mxq, myq = mxq.clamp(0, CULL_MAX - 1), myq.clamp(0, CULL_MAX - 1)
    reach = rq * 2 + 2
    x0, y0 = tx * tile_w, ty * tile_h
    dx = mxq - torch.minimum(torch.maximum(mxq, x0), x0 + tile_w - 1)
    dy = myq - torch.minimum(torch.maximum(myq, y0), y0 + tile_h - 1)
    return dx * dx + dy * dy <= reach * reach


class Walk(NamedTuple):
    """Pairs of (entry, pixel) that the stop rule walks, and of those the
    pairs blended; entries kept after the per-tile cap."""

    walked: int
    blended: int
    entries: int


def _blocks(counts, tiles_total: int, pixels: int):
    """Tiles with entries, longest first, cut into blocks that each hold
    at most BLOCK_ELEMS padded elements."""
    order = torch.argsort(counts, descending=True)
    cnt = counts[order].tolist()
    out, i = [], 0
    while i < tiles_total and cnt[i] > 0:
        k = cnt[i]
        n = max(1, BLOCK_ELEMS // (k * pixels))
        j = min(i + n, tiles_total)
        out.append((order[i:j], k))
        i = j
    return out


def _blend_block(s: Splats, lists: TileLists, tiles, k: int, tw: int,
                 th: int, tiles_x: int, cap: int, bg, dtype):
    """Colour (Tb, P, 3) and final transmittance (Tb, P) of a block of
    tiles, and its walked and blended pair counts."""
    dev = tiles.device
    lo = lists.offsets[tiles]
    cnt = torch.clamp(lists.counts[tiles], max=cap)
    kk = torch.arange(k, device=dev)
    valid = kk[None, :] < cnt[:, None]
    idx = torch.where(valid, lo[:, None] + kk[None, :], torch.zeros_like(lo)[:, None])
    g = torch.where(valid, lists.gid[idx], torch.zeros_like(idx))
    pix = torch.arange(tw * th, device=dev)
    px = ((tiles % tiles_x) * tw)[:, None] + pix % tw
    py = ((tiles // tiles_x) * th)[:, None] + torch.div(pix, tw, rounding_mode="floor")
    mean = s.means2d[g]                                   # (Tb, K, 2)
    con = s.conic[g]
    dx = px.to(dtype)[:, None, :] - mean[..., 0:1]
    dy = py.to(dtype)[:, None, :] - mean[..., 1:2]
    power = -0.5 * (con[..., 0:1] * dx * dx + con[..., 2:3] * dy * dy) \
        - con[..., 1:2] * dx * dy
    op = torch.where(valid, s.opacity[g], torch.zeros_like(s.opacity[g]))
    alpha = torch.clamp(op[..., None] * torch.exp(power), max=ALPHA_MAX)
    alpha = torch.where((power <= 0) & (alpha >= ALPHA_MIN), alpha,
                        torch.zeros_like(alpha))
    t_incl = torch.cumprod(1 - alpha, dim=1)
    live = t_incl >= T_MIN                                 # a prefix per pixel
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], 1)
    wgt = torch.where(live, alpha * t_excl, torch.zeros_like(alpha))
    color = torch.einsum("tkp,tkc->tpc", wgt, s.color[g])
    t_fin = torch.where(live, 1 - alpha, torch.ones_like(alpha)).prod(1)
    color = color + t_fin[..., None] * bg.to(dtype)
    with torch.no_grad():
        n_live = live.sum(1)                               # (Tb, P)
        walked = int((n_live + (n_live < cnt[:, None]).long()).sum())
        blended = int((live & (alpha > 0)).sum())
    return color, t_fin, walked, blended, py, px


def render(s: Splats, lists: TileLists, h: int, w: int, tile_w: int,
           tile_h: int, max_per_tile: int, bg, dtype=torch.float32,
           grad_img: Optional[torch.Tensor] = None):
    """The frame (3, h, w) of ``s`` through ``lists``, and its Walk. With
    ``grad_img`` (3, h, w), autograd instead carries that cotangent back
    into the tensors of ``s`` (which must require grad), block by block,
    and the frame is returned detached."""
    tiles_x, tiles_y = -(-w // tile_w), -(-h // tile_h)
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    img = torch.zeros(3, hp, wp, dtype=dtype, device=s.means2d.device)
    img[:] = bg.to(dtype)[:, None, None]
    gpad = None
    if grad_img is not None:
        gpad = torch.zeros(3, hp, wp, dtype=grad_img.dtype,
                           device=grad_img.device)
        gpad[:, :h, :w] = grad_img
    walked = blended = 0
    for tiles, k in _blocks(lists.counts.clamp(max=max_per_tile),
                            tiles_x * tiles_y, tile_w * tile_h):
        with torch.set_grad_enabled(grad_img is not None):
            color, _, wk, bl, py, px = _blend_block(
                s, lists, tiles, min(k, max_per_tile), tile_w, tile_h,
                tiles_x, max_per_tile, bg, dtype)
            if gpad is not None:
                gc = gpad[:, py, px].permute(1, 2, 0)
                torch.autograd.backward(color, gc.to(color.dtype))
        img[:, py, px] = color.detach().permute(2, 0, 1)
        walked += wk
        blended += bl
    entries = int(lists.counts.clamp(max=max_per_tile).sum())
    return img[:, :h, :w], Walk(walked, blended, entries)


def _window(dtype, device):
    x = torch.arange(11, dtype=torch.float64, device=device) - 5
    g = torch.exp(-x * x / (2 * 1.5 ** 2))
    g = g / g.sum()
    return (g[:, None] * g[None, :]).to(dtype)


def ssim_map(x, y):
    """SSIM of (C, H, W) images with an 11x11 Gaussian window (sigma 1.5)
    and zero padding, as one depthwise 2-D convolution."""
    c = x.shape[0]
    win = _window(x.dtype, x.device)[None, None].expand(c, 1, 11, 11)

    def blur(t):
        return torch.nn.functional.conv2d(t[None], win, padding=5,
                                          groups=c)[0]

    mx, my = blur(x), blur(y)
    sxx = blur(x * x) - mx * mx
    syy = blur(y * y) - my * my
    sxy = blur(x * y) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mx * my + c1) * (2 * sxy + c2)) / (
        (mx * mx + my * my + c1) * (sxx + syy + c2))


def camera_loss(img, gt, lambda_dssim: float):
    """(1 - lambda) L1 + lambda (1 - SSIM), each a mean over 3 H W."""
    l1 = torch.abs(img - gt).mean()
    ss = ssim_map(img, gt).mean()
    return (1 - lambda_dssim) * l1 + lambda_dssim * (1 - ss)


