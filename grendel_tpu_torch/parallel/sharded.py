"""The distributed training step: Gaussian sharding x pixel sharding.

Counterpart of grendel_tpu/parallel/sharded.py, with one process per
device on torch.distributed (parallel/comm.py: NCCL on the card, gloo on
the CPU) in place of ``shard_map`` over a mesh (SURVEY.md §2.1-§2.4):

  * **Gaussian sharding**: each rank owns a contiguous slice of the
    capacity axis (parameters, Adam moments, alive mask, densify
    statistics), as ``P('d')`` cuts it.
  * **Pixel sharding**: the tile rows of the batch's images form one global
    row axis (row = cam * tiles_y + ty); each rank renders the span
    ``division_pos[rank]:division_pos[rank + 1]`` (parallel/division.py).
  * **The sparse all-to-all**: each rank projects its slice for every
    camera, finds the ranks whose row spans each visible Gaussian's box
    touches, packs (means2d | conic | rgb | opacity) into fixed-capacity
    per-destination buckets (:func:`pack_for_exchange`), and exchanges
    them with one differentiable all-to-all (the gradients ride the
    backward exchange to the owning rank), plus one plain all-to-all of
    (camera, radius, depth, valid).
  * **The sharded loss**: each rank renders its rows and computes its
    masked L1 + SSIM over them, normalized by the global pixel count; the
    sum over ranks is the global loss.

``gaussians_distribution=False`` is the replicated mode: every rank holds
every Gaussian, renders its rows without an exchange, and the gradients
are summed over ranks and then normalized by visibility.

Each rank backpropagates its own partial loss; the gradients that reach a
Gaussian sum to the gradient of the global loss the step reports. (The
JAX package differentiates ``psum(partial)`` under ``shard_map`` with
``check_vma=False``, whose transpose is a second ``psum``, so its
gradients at D devices are D times the global loss's; the port does not
copy that.)

The bucket capacity ``send_cap`` stays fixed, as in the JAX package: the
overflow and demand counts it gives are the telemetry a capacity tuner
reads, and no step reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cameras import CameraArrays
from ..engine.train import (TrainState, XyzLrSchedule,
                            normalize_grads_by_visibility)
from ..models.densify import (SPLIT_N, accumulate_densify_stats,
                              densify_and_prune, reset_opacity)
from ..models.gaussian_model import GaussianParams
from ..models.optimizer import LrConfig, adam_step
from ..ops.isect import (compact_entries_blocked, compact_entries_flat,
                         isect_tile_rows, isect_tile_rows_blocked)
from ..ops.projection import ProjectedSplats, project_params
from ..ops.rasterize_cuda import rasterize_slots_fwd
from ..ops.ssim import ssim_map
from ..utils import prng
from . import comm

PAYLOAD_F = 9   # means2d(2) + conic(3) + rgb(3) + opacity(1)
META_F = 4      # cam, radius, depth, valid
SSIM_GAP = 8    # zero rows between cameras in the tall image (> 11 // 2)
I32 = torch.int32


class ParallelConfig(NamedTuple):
    """Shape and shard configuration of the distributed step."""

    n_devices: int
    bsz: int
    img_h: int
    img_w: int
    tile_w: int = 16
    tile_h: int = 16
    n_row_slots: int = 0        # per-rank row buffer (0 = auto)
    send_cap: int = 0           # per-destination bucket (0 = auto vs N_loc)
    isect_capacity: int = 1 << 18   # tile-list entries of a rank's rows
    blend_capacity: int = 0     # post-cull entry budget (0 = isect_capacity)
    max_per_tile: int = 2048
    row_slack: float = 2.0      # n_row_slots = slack * ceil(rows / D)
    send_cap_factor: float = 1.0  # send_cap = factor * N_loc
    # False = replicated Gaussians + summed gradients (pixel sharding stays)
    gaussians_distribution: bool = True
    # the step draws its background: JAX's uniform(fold_in(key(bg_seed),
    # iteration), (3,)) from the state's iteration, on the device, the
    # same on every rank; the host loops leave it off and draw their own
    random_background: bool = False
    bg_seed: int = 0

    @property
    def tiles_x(self) -> int:
        return -(-self.img_w // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.img_h // self.tile_h)

    @property
    def total_rows(self) -> int:
        return self.bsz * self.tiles_y

    def resolved(self, n_local: int) -> "ParallelConfig":
        out = self
        if out.blend_capacity == 0 or out.blend_capacity > out.isect_capacity:
            out = out._replace(blend_capacity=out.isect_capacity)
        else:
            align = 128 * max(1, out.bsz)
            out = out._replace(blend_capacity=min(
                out.isect_capacity, -(-out.blend_capacity // align) * align))
        if out.n_row_slots == 0:
            per = -(-out.total_rows // out.n_devices)
            out = out._replace(n_row_slots=min(
                out.total_rows, int(np.ceil(per * out.row_slack))))
        if out.send_cap == 0:
            out = out._replace(
                send_cap=max(256, int(n_local * out.send_cap_factor)))
        return out


# --------------------------------------------------------------------------
# the per-rank pieces
# --------------------------------------------------------------------------


def project_batch(params: GaussianParams, alive, cams: CameraArrays,
                  cfg: ParallelConfig, sh_degree: int) -> ProjectedSplats:
    """Activate and project for every camera: (B, N, ...) leaves."""
    return project_params(params, alive, cams, cfg.img_h, cfg.img_w,
                          sh_degree)


def payload_and_meta(means2d, conics, rgbs, opacs, radii, depths):
    """(B*N, PAYLOAD_F) differentiable payload and (B*N, META_F) plain
    metadata (camera, radius, depth, valid) of (B, N) projected splats,
    camera-major."""
    b, n = radii.shape
    payload = torch.cat([means2d.reshape(-1, 2), conics.reshape(-1, 3),
                         rgbs.reshape(-1, 3), opacs.reshape(-1, 1)], dim=-1)
    cam_of = torch.arange(b * n, device=radii.device) // n
    meta = torch.stack([cam_of.to(torch.float32),
                        radii.reshape(-1).to(torch.float32),
                        depths.detach().reshape(-1),
                        torch.ones(b * n, device=radii.device)], dim=-1)
    return payload, meta


def pack_for_exchange(means2d, conics, rgbs, opacs, radii, depths,
                      division_pos, cfg: ParallelConfig):
    """One rank's half of the sparse all-to-all, before the collective.

    Each visible (camera, Gaussian) goes to every rank whose row span its
    box's tile rows touch, into that rank's bucket of ``send_cap`` slots in
    (camera, Gaussian) order; entries past a full bucket are dropped.
    Returns (send_payload (D, cap, PAYLOAD_F), differentiable;
    send_meta (D, cap, META_F); n_overflow (), the entries dropped; and
    n_demand (), the largest bucket's true count)."""
    d_count, cap = cfg.n_devices, cfg.send_cap
    b, n = radii.shape
    dev = radii.device
    tiles_y, tile_h = cfg.tiles_y, cfg.tile_h
    pos_d = division_pos.to(device=dev, dtype=I32)

    # destination ranks [d0, d1] of each (camera, Gaussian)
    r = radii.to(torch.float32)
    my = means2d.detach()[..., 1]
    y0 = torch.clamp(torch.floor((my - r) / tile_h), 0, tiles_y).to(I32)
    y1 = torch.clamp(torch.floor((my + r + tile_h - 1) / tile_h), 0,
                     tiles_y).to(I32)
    b_rows = (torch.arange(b, device=dev, dtype=I32) * tiles_y)[:, None]
    g0, g1 = b_rows + y0, b_rows + y1            # global rows [g0, g1)
    ok = (radii > 0) & (g1 > g0)
    d0 = torch.searchsorted(pos_d, g0, right=True, out_int32=True) - 1
    d1 = torch.searchsorted(pos_d, torch.clamp(g1 - 1, min=0), right=True,
                            out_int32=True) - 1
    n_dest = torch.where(ok, d1 - d0 + 1, torch.zeros_like(d0))

    # (B, N, D) copies, stably sorted by destination; rank in destination
    j = torch.arange(d_count, device=dev, dtype=I32)
    active = j < n_dest[..., None]
    flat_dest = torch.where(active, d0[..., None] + j,
                            torch.full_like(active, d_count, dtype=I32)
                            ).reshape(-1)
    sorted_dest, perm = torch.sort(flat_dest, stable=True)
    dest_start = torch.searchsorted(
        sorted_dest, torch.arange(d_count + 1, device=dev, dtype=I32),
        out_int32=True)
    rank = (torch.arange(sorted_dest.shape[0], device=dev, dtype=I32)
            - dest_start[sorted_dest.long()])
    in_cap = (sorted_dest < d_count) & (rank < cap)
    slot = torch.where(in_cap, sorted_dest * cap + rank,
                       torch.full_like(rank, d_count * cap))
    counts = dest_start[1:] - dest_start[:-1]
    n_overflow = torch.clamp(counts - cap, min=0).sum()
    n_demand = counts.max()

    # each copy's row into its slot; the dropped ones land in a spare row.
    # The differentiable payload's rows are repeated D times (copy k*D + j)
    # and the copies gathered by the permutation: the backward sums a
    # row's D copies over the repeat's axis, in a fixed order, and its
    # gather's adds land one on each row. A gather of row perm // D, as
    # meta takes (it has no gradient), would add up to D copies into a row
    # with atomics, in an order that changes from run to run. An indexing
    # gather's backward would sort its indices and walk each run of equal
    # ones, hence index_select and index_copy.
    payload, meta = payload_and_meta(means2d, conics, rgbs, opacs, radii,
                                     depths)
    slot = slot.long()

    def scatter(x, index):
        rows = x.new_zeros(d_count * cap + 1, x.shape[1])
        return rows.index_copy(0, slot, x.index_select(0, index))[:-1]

    copies = payload[:, None, :].expand(-1, d_count, -1).reshape(-1, PAYLOAD_F)
    src = torch.div(perm, d_count, rounding_mode="floor")
    return (scatter(copies, perm).reshape(d_count, cap, PAYLOAD_F),
            scatter(meta, src).reshape(d_count, cap, META_F), n_overflow,
            n_demand)


class OwnedRows(NamedTuple):
    rows: torch.Tensor           # (R, 3, tile_h, W) rendered rows
    mask: torch.Tensor           # (R, tile_h, W) pixels of owned rows
    cam_of_row: torch.Tensor     # (R,)
    per_row_entries: torch.Tensor  # (R,) int32 tile-list entries per row
    num_isects: torch.Tensor     # () int32
    num_kept: torch.Tensor       # () int32


def render_owned_rows(recv_payload, recv_meta, row_lo, row_hi,
                      cfg: ParallelConfig, bg,
                      camera_major: bool = False) -> OwnedRows:
    """Rasterize the owned tile-row span [row_lo, row_hi) (ints or 0-d
    tensors) from the received entries ((M, PAYLOAD_F), (M, META_F)).

    With one device, every row owned and a camera-major universe (camera
    c's entries at [c*M/B, (c+1)*M/B): the replicated payload, not an
    exchanged one), the whole batch takes the camera-blocked tile lists of
    ``engine.render.render_batch``; otherwise the flat row-span lists
    (:func:`..ops.isect.isect_tile_rows`). Kernel K3 carries both lists'
    scans on the card, K1 and K2 the blend."""
    tiles_x, tiles_y = cfg.tiles_x, cfg.tiles_y
    r_slots, bsz = cfg.n_row_slots, cfg.bsz
    dev = recv_payload.device
    means2d = recv_payload[:, 0:2]
    conics = recv_payload[:, 2:5]
    rgbs = recv_payload[:, 5:8]
    opacs = recv_payload[:, 8]
    cams = recv_meta[:, 0].to(I32)
    valid = recv_meta[:, 3] > 0
    radii = torch.where(valid, recv_meta[:, 1],
                        torch.zeros_like(recv_meta[:, 1])).to(I32)
    depths = torch.where(valid, recv_meta[:, 2],
                         torch.full_like(recv_meta[:, 2], float("inf")))
    m2d_d, op_d = means2d.detach(), opacs.detach()

    s = torch.arange(r_slots * tiles_x, device=dev, dtype=I32)
    px0 = (s % tiles_x) * cfg.tile_w
    py0 = ((row_lo + s // tiles_x) % tiles_y) * cfg.tile_h

    bb = cfg.blend_capacity
    blocked = (camera_major and cfg.n_devices == 1
               and r_slots == bsz * tiles_y
               and recv_payload.shape[0] % bsz == 0
               and cfg.isect_capacity % (bsz * 128) == 0)
    if blocked:
        isect = isect_tile_rows_blocked(
            m2d_d, radii, depths, bsz, cfg.tile_w, cfg.tile_h, tiles_x,
            tiles_y, capacity=cfg.isect_capacity, opacities=op_d)
        ids, tlo, thi = isect.gauss_ids, isect.tile_lo, isect.tile_hi
        if bb < cfg.isect_capacity and bb % (bsz * 128) == 0:
            ids, tlo, thi = compact_entries_blocked(
                ids, tlo, thi, bsz, tiles_x * tiles_y,
                cfg.isect_capacity // bsz, bb // bsz)
        colors, t_final = rasterize_slots_fwd(
            means2d, conics, rgbs, opacs, ids, None, px0, py0, cfg.tile_w,
            cfg.tile_h, cfg.max_per_tile, tile_lo=tlo, tile_hi=thi)
        n_per_slot = thi - tlo
    else:
        isect = isect_tile_rows(
            m2d_d, radii, depths, cams, row_lo, row_hi, cfg.tile_w,
            cfg.tile_h, tiles_x, tiles_y, r_slots, cfg.isect_capacity,
            opacities=op_d)
        ids, toff = isect.gauss_ids, isect.tile_offsets
        if bb < cfg.isect_capacity and bb % 128 == 0:
            ids, toff = compact_entries_flat(ids, toff, bb)
        colors, t_final = rasterize_slots_fwd(
            means2d, conics, rgbs, opacs, ids, toff, px0, py0, cfg.tile_w,
            cfg.tile_h, cfg.max_per_tile)
        n_per_slot = toff[1:] - toff[:-1]
    colors = colors + t_final[..., None] * bg[None, None, :]

    # (S, P, 3) -> (R, 3, tile_h, W)
    rows = colors.reshape(r_slots, tiles_x, cfg.tile_h, cfg.tile_w, 3)
    rows = rows.permute(0, 2, 1, 3, 4).reshape(
        r_slots, cfg.tile_h, tiles_x * cfg.tile_w, 3)
    rows = rows[:, :, :cfg.img_w].permute(0, 3, 1, 2)

    row_ids = row_lo + torch.arange(r_slots, device=dev, dtype=I32)
    y_img = ((row_ids % tiles_y)[:, None] * cfg.tile_h
             + torch.arange(cfg.tile_h, device=dev, dtype=I32)[None, :])
    mask = (row_ids < row_hi)[:, None, None] & (y_img < cfg.img_h)[:, :, None]
    mask = mask.expand(r_slots, cfg.tile_h, cfg.img_w)
    cam_of_row = torch.clamp(row_ids // tiles_y, 0, bsz - 1)
    per_row = n_per_slot.reshape(r_slots, tiles_x).sum(dim=1, dtype=I32)
    return OwnedRows(rows, mask, cam_of_row, per_row, isect.num_isects,
                     isect.num_kept)


def row_span_loss(rows, gt_rows, mask, cam_of_row, cfg: ParallelConfig,
                  lambda_dssim: float):
    """Masked partial loss over owned rows (the reference's
    loss_distribution.py:2536-2585). ``gt_rows`` is float in [0, 1].

    Returns (partial, l1_partial, ssim_partial): the global loss is the sum
    of the partials over ranks + lambda * bsz, the global L1 and SSIM sums
    the sums of theirs.

    SSIM runs once over a "gapped tall image": the rows in global order,
    so each camera's rows are contiguous, with SSIM_GAP zero rows between
    cameras, which gives every camera the zero-padded border of a per-span
    convolution."""
    denom = 3.0 * cfg.img_h * cfg.img_w
    m = mask.to(torch.float32)[:, None, :, :]
    l1_part = torch.sum(torch.abs(rows - gt_rows) * m) / denom

    r_slots = rows.shape[0]
    th, w = cfg.tile_h, cfg.img_w
    dev = rows.device
    tall_h = r_slots * th + cfg.bsz * SSIM_GAP
    y0 = torch.arange(r_slots, device=dev) * th + cam_of_row * SSIM_GAP
    y_idx = (y0[:, None] + torch.arange(th, device=dev)[None, :]).reshape(-1)

    def to_tall(x):               # (R, 3, th, W) -> (3, tall_h, W)
        flat = x.permute(1, 0, 2, 3).reshape(3, r_slots * th, w)
        return torch.zeros((3, tall_h, w), dtype=torch.float32,
                           device=dev).index_copy(1, y_idx.long(), flat)

    m3 = m.expand(rows.shape)
    smap = ssim_map(to_tall(rows * m), to_tall(gt_rows * m))
    ssim_part = torch.sum(smap * to_tall(m3)[0][None]) / denom
    partial = (1.0 - lambda_dssim) * l1_part - lambda_dssim * ssim_part
    return partial, l1_part, ssim_part


def rows_to_images(rows, mask, row_lo, row_hi, cfg: ParallelConfig):
    """One rank's rows, masked to [row_lo, row_hi), scattered into a zero
    (B, 3, H, W) stack; the sum over ranks is the batch's images."""
    tiles_y, r_slots, bsz = cfg.tiles_y, cfg.n_row_slots, cfg.bsz
    dev = rows.device
    rows = rows * mask[:, None, :, :]
    row_ids = row_lo + torch.arange(r_slots, device=dev, dtype=I32)
    ty = (row_ids % tiles_y).long()
    b_of = torch.where(row_ids < row_hi, row_ids // tiles_y,
                       torch.full_like(row_ids, bsz)).long()
    imgs = torch.zeros((bsz + 1, 3, tiles_y, cfg.tile_h, cfg.img_w),
                       dtype=rows.dtype, device=dev)
    imgs[b_of, :, ty] = rows          # slot bsz takes the unowned rows
    imgs = imgs[:bsz].reshape(bsz, 3, tiles_y * cfg.tile_h, cfg.img_w)
    return imgs[:, :, :cfg.img_h]


def owned_loss(recv_payload, recv_meta, row_lo, row_hi, gt_rows_u8, bg,
               cfg: ParallelConfig, lambda_dssim: float,
               camera_major: bool = False):
    """Render the owned rows and take their partial loss against the
    rank's uint8 ground-truth rows (R, 3, tile_h, W). Returns (partial,
    l1_partial, ssim_partial, OwnedRows)."""
    own = render_owned_rows(recv_payload, recv_meta, row_lo, row_hi, cfg, bg,
                            camera_major)
    gt = gt_rows_u8.to(torch.float32) / 255.0
    partial, l1_part, ssim_part = row_span_loss(
        own.rows, gt, own.mask, own.cam_of_row, cfg, lambda_dssim)
    return partial, l1_part, ssim_part, own


def _aux(l1_part, ssim_part, radii, own: OwnedRows, n_overflow, n_demand):
    return {"l1_partial": l1_part, "ssim_partial": ssim_part,
            "radii": radii, "per_row_entries": own.per_row_entries,
            "num_isects": own.num_isects, "num_kept": own.num_kept,
            "a2a_overflow": n_overflow, "a2a_demand": n_demand}


def local_forward(params_loc: GaussianParams, alive_loc, tap, cams,
                  gt_rows_u8, division_pos, rank: int, bg,
                  cfg: ParallelConfig, sh_degree: int, lambda_dssim: float):
    """Gaussian-sharded forward of one rank: project the rank's slice for
    every camera, pack, exchange, render the owned rows, and take their
    partial loss. ``tap`` ((B, N_loc, 2) zeros) is added to the projected
    means, so its gradient is d(loss)/d(means2d). Returns (partial, aux)."""
    splats = project_batch(params_loc, alive_loc, cams, cfg, sh_degree)
    send_p, send_m, n_overflow, n_demand = pack_for_exchange(
        splats.means2d + tap, splats.conics, splats.colors, splats.opacities,
        splats.radii, splats.depths, division_pos, cfg)
    recv_p = comm.all_to_all(send_p).reshape(-1, PAYLOAD_F)
    recv_m = comm.all_to_all(send_m).reshape(-1, META_F)
    partial, l1_part, ssim_part, own = owned_loss(
        recv_p, recv_m, division_pos[rank], division_pos[rank + 1],
        gt_rows_u8, bg, cfg, lambda_dssim)
    return partial, _aux(l1_part, ssim_part, splats.radii, own, n_overflow,
                         n_demand)


def local_forward_replicated(params: GaussianParams, alive, tap, cams,
                             gt_rows_u8, division_pos, rank: int, bg,
                             cfg: ParallelConfig, sh_degree: int,
                             lambda_dssim: float):
    """Replicated forward of one rank: project every Gaussian and render
    the owned rows, with no exchange. Returns (partial, aux)."""
    splats = project_batch(params, alive, cams, cfg, sh_degree)
    payload, meta = payload_and_meta(
        splats.means2d + tap, splats.conics, splats.colors, splats.opacities,
        splats.radii, splats.depths)
    partial, l1_part, ssim_part, own = owned_loss(
        payload, meta, division_pos[rank], division_pos[rank + 1],
        gt_rows_u8, bg, cfg, lambda_dssim, camera_major=True)
    zero = torch.zeros((), dtype=I32, device=payload.device)
    return partial, _aux(l1_part, ssim_part, splats.radii, own, zero, zero)


# --------------------------------------------------------------------------
# the distributed trainer
# --------------------------------------------------------------------------


def shard_state(state: TrainState, rank: int, world: int,
                replicated: bool) -> TrainState:
    """Rank ``rank``'s part of a whole state: its contiguous slice of every
    per-Gaussian tensor, or the whole state when replicated."""
    capacity = state.alive.shape[0]
    if replicated:
        sl = slice(0, capacity)
    elif capacity % world:
        raise ValueError(f"capacity {capacity} does not divide by {world} "
                         f"ranks")
    else:
        n_loc = capacity // world
        sl = slice(rank * n_loc, (rank + 1) * n_loc)

    def cut(x):
        return x[sl].clone()

    return TrainState(
        params=GaussianParams(*map(cut, state.params)),
        alive=cut(state.alive),
        adam=state.adam._replace(
            mu=GaussianParams(*map(cut, state.adam.mu)),
            nu=GaussianParams(*map(cut, state.adam.nu))),
        stats=type(state.stats)(*map(cut, state.stats)),
        iteration=state.iteration)


class DistributedTrainer:
    """The distributed train, render, densify and opacity-reset steps of
    one rank of the default torch.distributed group (the JAX package's
    ``ShardedTrainer``), on the rank's device: the current CUDA device
    under NCCL, the CPU under gloo. Every rank calls every method in the
    same order."""

    def __init__(self, cfg: ParallelConfig, sh_degree: int,
                 lambda_dssim: float, lrs: LrConfig, xyz_sched: XyzLrSchedule,
                 lr_scale_mode: str = "sqrt", lr_scale_loss: float = 1.0,
                 grad_normalization_mode: str = "none"):
        import torch.distributed as dist

        self.cfg = cfg
        self.sh_degree = sh_degree
        self.lambda_dssim = lambda_dssim
        self.lrs = lrs
        self.xyz_sched = xyz_sched
        self.lr_scale_mode = lr_scale_mode
        self.lr_scale_loss = lr_scale_loss
        self.grad_normalization_mode = grad_normalization_mode
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        if self.world != cfg.n_devices:
            raise ValueError(f"the group has {self.world} ranks, the "
                             f"config {cfg.n_devices} devices")
        self.replicated = not cfg.gaussians_distribution
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend() == "nccl"
                       else torch.device("cpu"))

    def shard_state(self, state: TrainState) -> TrainState:
        """This rank's part of a whole state (:func:`shard_state`)."""
        return shard_state(state, self.rank, self.world, self.replicated)

    def _forward(self, params, alive, tap, cams, gt_rows_u8, division_pos, bg):
        fwd = local_forward_replicated if self.replicated else local_forward
        return fwd(params, alive, tap, cams, gt_rows_u8, division_pos,
                   self.rank, bg, self.cfg, self.sh_degree, self.lambda_dssim)

    # -- the steps -----------------------------------------------------------

    def step(self, state: TrainState, cams: CameraArrays, gt_rows_u8,
             division_pos, bg):
        """One distributed training step on this rank's ``state`` and its
        ground-truth rows (R, 3, tile_h, W) uint8. ``division_pos`` (D+1,)
        int32 is the same on every rank. Returns (new_state, metrics)."""
        cfg, bsz = self.cfg, self.cfg.bsz
        if cfg.random_background:
            # from the iteration tensor: no read back to the host
            bg = prng.uniform(prng.fold_in(prng.key(cfg.bg_seed),
                                           state.iteration), (3,), 0.0, 1.0,
                              self.device)
        n_loc = state.alive.shape[0]
        leaves = [p.detach().requires_grad_(True) for p in state.params]
        tap = torch.zeros((bsz, n_loc, 2), dtype=torch.float32,
                          device=self.device, requires_grad=True)
        partial, aux = self._forward(GaussianParams(*leaves), state.alive,
                                     tap, cams, gt_rows_u8, division_pos, bg)
        # this rank's partial only: the exchange's backward carries the
        # other ranks' shares of each Gaussian's gradient here
        *grads, tap_grad = torch.autograd.grad(partial * self.lr_scale_loss,
                                               leaves + [tap])
        if self.replicated:
            # each rank's backward covers its own rows: sum them, then
            # normalize (the tap gradient stays raw for the densify stats)
            *grads, tap_grad = comm.all_reduce_sum(grads + [tap_grad])
            grads = normalize_grads_by_visibility(
                GaussianParams(*grads), aux["radii"],
                self.grad_normalization_mode)
        grads = GaussianParams(*grads)
        if self.lr_scale_mode != "accumu":
            grads = GaussianParams(*(g / bsz for g in grads))

        stats = accumulate_densify_stats(state.stats, tap_grad, aux["radii"],
                                         cfg.img_w, cfg.img_h)
        xyz_lr = self.xyz_sched(state.iteration)
        params, adam = adam_step(state.params, grads, state.adam, self.lrs,
                                 xyz_lr, state.alive)
        new_state = TrainState(params=params, alive=state.alive, adam=adam,
                               stats=stats, iteration=state.iteration + bsz)

        sums, = comm.all_reduce_sum([torch.stack(
            [partial.detach(), aux["l1_partial"].detach(),
             aux["ssim_partial"].detach()])])
        counts = torch.stack([aux["num_isects"], aux["num_kept"],
                              aux["a2a_overflow"], aux["a2a_demand"]]).to(I32)
        tele = comm.all_gather(torch.cat([aux["per_row_entries"],
                                          counts]))       # (D, R + 4)
        r = cfg.n_row_slots
        num_isects, num_kept, overflow, demand = (tele[:, r + i]
                                                  for i in range(4))
        metrics = {
            "loss": (sums[0] + self.lambda_dssim * bsz) * self.lr_scale_loss,
            "l1": sums[1],
            "ssim": sums[2],
            "per_row_entries": tele[:, :r],              # (D, R)
            "num_isects": num_isects,                    # (D,)
            "num_kept": num_kept,
            "a2a_overflow": overflow,
            "a2a_demand": demand,
            # (num_isects | a2a_overflow | a2a_demand | num_kept), (4D,)
            "telemetry": torch.cat([num_isects, overflow, demand,
                                    num_kept]).to(torch.float32),
            "xyz_lr": xyz_lr,
        }
        return new_state, metrics

    @torch.no_grad()
    def render(self, params: GaussianParams, alive, cams: CameraArrays,
               division_pos, bg):
        """The batch's images (B, 3, H, W), the same on every rank: each
        rank renders its rows, the stacks are summed over ranks."""
        cfg = self.cfg
        splats = project_batch(params, alive, cams, cfg, self.sh_degree)
        if self.replicated:
            payload, meta = payload_and_meta(
                splats.means2d, splats.conics, splats.colors,
                splats.opacities, splats.radii, splats.depths)
        else:
            send_p, send_m, _, _ = pack_for_exchange(
                splats.means2d, splats.conics, splats.colors,
                splats.opacities, splats.radii, splats.depths, division_pos,
                cfg)
            payload = comm.all_to_all(send_p).reshape(-1, PAYLOAD_F)
            meta = comm.all_to_all(send_m).reshape(-1, META_F)
        row_lo = division_pos[self.rank]
        row_hi = division_pos[self.rank + 1]
        own = render_owned_rows(payload, meta, row_lo, row_hi, cfg, bg,
                                camera_major=self.replicated)
        imgs = rows_to_images(own.rows, own.mask, row_lo, row_hi, cfg)
        return comm.all_reduce_sum([imgs])[0]

    def densify(self, state: TrainState, seed: int, grad_threshold: float,
                min_opacity: float, extent: float, percent_dense: float,
                use_size_prune: bool):
        """Densify and prune each shard on its own, with the split noise
        of :meth:`split_noise`. Returns (state, info (D, 5) int32: cloned,
        split, pruned, dropped, alive of each rank), with no readback."""
        params, alive, adam, stats, info = densify_and_prune(
            state.params, state.alive, state.adam, state.stats,
            self.split_noise(seed, state.alive.shape[0]),
            grad_threshold, min_opacity, extent, percent_dense,
            use_size_prune)
        info_all = comm.all_gather(info.to(I32))
        return (TrainState(params, alive, adam, stats, state.iteration),
                info_all)

    def split_noise(self, seed: int, n: int) -> torch.Tensor:
        """The standard-normal split offsets of one densify, (n, SPLIT_N,
        3): the JAX package's draw from the key ``seed``, folded with the
        rank when the Gaussians are sharded (the replicated copies must
        stay equal)."""
        key = prng.key(seed)
        if not self.replicated:
            key = prng.fold_in(key, self.rank)
        return prng.normal(key, (n, SPLIT_N, 3), self.device)

    def reset_opacity(self, state: TrainState) -> TrainState:
        params, adam = reset_opacity(state.params, state.adam)
        return state._replace(params=params, adam=adam)

