"""The host training loop on one GPU.

Counterpart of grendel_tpu/engine/trainer.py ``Trainer`` with one device
(the JAX package's replicated mode). Its subclass, engine/trainer_dist.py
``MultiRankTrainer``, is the loop of one rank of a torch.distributed
group, which drives parallel/sharded.py ``DistributedTrainer``;
``trainer_dist.make_trainer`` picks between the two. Per block of ``bsz``
iterations:

  batch sampling -> one ``train_step`` (engine/train.py: kernels K1, K2
  and K3 on the card) -> entry-capacity check on the previous step's
  count -> densify / prune / split with capacity growth, and opacity
  reset, on their schedule -> eval, PLY save and checkpoint at their
  iterations.

What it copies from the JAX loop: the bsz-scaled learning rates and the
xyz schedule's endpoints, the initial capacity round_capacity(max(int(1.5
n0), 512)), the SH ramp min(it // 1000, sh_degree), the densify and
opacity-reset schedule on the pre-increment iteration, the pre-grow ahead
of a densify from the last measured growth ratio, growth when a densify
dropped Gaussians or filled the capacity past the trigger (growth pads the
densify statistics, it does not reset them), the densify noise drawn
from the key seed * 1000003 + iteration by JAX's generator, the
exact-size last eval batch, the per-epoch loss log and the checkpoint's
tuner state.

The tile-list entry capacity (per batch, ``RenderConfig.isect_capacity``
per camera) starts at isect_capacity_factor x capacity and grows to
max(1.15 x the largest entry count seen, 1.35 x itself), mantissa-rounded,
when a step's count passes 0.92 of it, never past the entry ceiling. The
count is read one step late, after the next step is queued, so no step
waits on a readback; a step of an older capacity only feeds the peak (the
JAX loop's generation guard). A count over the capacity means that step
dropped its farthest entries; at the ceiling that is logged.

The entry ceiling starts at 2^22 and, after the first step of each entry
and Gaussian capacity (where the JAX loop compiles a new step), becomes
``utils/hbm.py entry_ceiling``: the capacity plus the entries that fit,
at ``BYTES_PER_ISECT_ENTRY`` each, in 90% of the device's memory above
the step's peak (``_update_hbm_ceiling``), and never past
``hbm.ENTRY_CAP_MAX`` (2^31 - 2^27), where int32 entry offsets would
overflow; the JAX loop has no such bound, and when the clamp binds the
port logs it on a line of its own after JAX's ceiling line. The peak is
the caching allocator's ``max_memory_allocated`` over that step, after a
reset just before it: host-side statistics, so the reading waits for
nothing. The loop keeps its own running maxima across those resets for
its memory line (``peak_memory``). On the CPU there is no reading and
the ceiling stays at 2^22, as the JAX loop's does on the CPU without
``GRENDEL_HBM_GB``; on the card a missing reading raises.

The training cameras go up once to the device; each step indexes them.
The ground truth goes up once too, as a uint8 bank that each step
indexes, only where the dataset is preloaded (``_apply_preload_rule``);
otherwise it stays on the host, decoded at load or on demand
(``Camera.gt``), and each step packs its batch's images into a pinned
staging buffer and copies them behind the queued work (``PinnedUpload``),
the JAX loop's host path. With ``random_background`` the loop draws
each step's background, JAX's ``uniform(fold_in(key(cfg.seed),
iteration), (3,))`` at the step's pre-increment iteration
(grendel_tpu/parallel/sharded.py:637-646), bit for bit: on the host from
the iteration it counts (``prng.uniform_host``), uploaded from pinned
memory behind the queued work, so the step gains one copy and no
synchronizing call, and a resumed run draws what the unbroken one draws.

Densification stops while the device's live tensors pass
``densify_memory_limit_percentage`` of its memory (the JAX loop's memory
guard, the reference's ``check_memory_usage_and_adjust``); on the CPU
there is no live share, and the guard reads the measured step's share as
the JAX loop does where the runtime reports none (never, without a
reading). It is read only when a densify round is due.

With ``local_sampling`` the batches come from ``next_batch_grouped`` with
one group, and ``save_strategy_history`` writes the (whole-batch)
division of every step, as the JAX loop does on one device. As in the
JAX loop, a dataset below ``preload_dataset_to_gpu_threshold`` GB (or
``preload_dataset_to_gpu``) switches ``local_sampling`` and distributed
storage off (:meth:`Trainer._apply_preload_rule`).

``nsys_profile`` traces about 10 steps with ``torch.profiler`` into
``<model_path>/trace`` and ``log_memory_summary`` adds the card's
largest reservation to the memory line. Under autograd's anomaly mode
(the CLI's ``--detect_anomaly``, the JAX script's ``jax_debug_nans``)
the loop raises on a non-finite loss.

Not ported, being TPU workarounds: the recompile generation tags, the
blend-budget tuner (the render gets no post-cull budget) and the trainer
cache.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..cameras import Camera, batch_camera_arrays
from ..config import TrainConfig, check_update_at_this_iter
from ..data.readers import PointCloud
from ..data.scene import SceneDataset
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.densify import (SPLIT_N, DensifyStats, densify_and_prune,
                              reset_opacity)
from ..models.gaussian_model import (GaussianParams, init_from_pcd,
                                     pad_to_capacity, round_capacity)
from ..models.optimizer import AdamState, scaled_lrs
from ..utils import hbm, prng
from ..utils.hbm import device_bytes_limit, entry_ceiling, mantissa_round_cap
from ..utils.timer import End2endTimer, Timer, Tracer
from .checkpoint import (load_checkpoint_sharded, load_tuner_state,
                         save_checkpoint, save_tuner_state)
from .gaussian_io import save_ply
from .render import RenderConfig, render_batch
from .train import TrainState, XyzLrSchedule, train_state_init, train_step

ISECT_CAP_FLOOR = 1 << 14     # the entry capacity never goes below this
ISECT_CAP_CEILING = 1 << 22   # the entry ceiling until a step is measured


class PinnedUpload:
    """Uploads of uint8 ground truth from the host through two pinned
    staging buffers. A buffer is refilled only after the event recorded
    behind its last copy has passed, so no copy in flight is overwritten;
    the copy runs behind the queued work, and the host makes no
    synchronizing call (the event it waits on belongs to the step before
    the last, which the loop's readback has already waited for). On the
    CPU the filled array is the tensor."""

    def __init__(self, device):
        self.device = device
        self._slots: list = []      # [pinned buffer, event of its copy]
        self._next = 0

    def __call__(self, shape, fill) -> torch.Tensor:
        """``fill(buf)`` writes all of the uint8 numpy array ``buf`` of
        ``shape``; returns its contents on the device."""
        if self.device.type != "cuda":
            buf = np.empty(shape, np.uint8)
            fill(buf)
            return torch.from_numpy(buf)
        if not self._slots or tuple(self._slots[0][0].shape) != tuple(shape):
            self._slots = [[torch.empty(shape, dtype=torch.uint8,
                                        pin_memory=True), None]
                           for _ in range(2)]
        slot = self._slots[self._next]
        self._next ^= 1
        if slot[1] is not None:
            slot[1].synchronize()
        fill(slot[0].numpy())
        out = slot[0].to(self.device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return out


def device_gt_bank(cams, rows: int, device) -> torch.Tensor:
    """(C, 3, rows, W) uint8 ground truth of ``cams`` on ``device``, zero
    below each image, copied one camera at a time from
    ``Camera.gt(cache=False)``: a camera stored lazily is decoded too, so
    no camera's ground truth is left at zero (the JAX loop's bank copies
    only the cameras decoded at load)."""
    c0 = cams[0]
    bank = torch.zeros((len(cams), 3, rows, c0.width), dtype=torch.uint8,
                       device=device)
    for i, c in enumerate(cams):
        bank[i, :, :c0.height] = torch.from_numpy(c.gt(cache=False))
    return bank


def _batched_psnr_l1(imgs: torch.Tensor, gt_u8: torch.Tensor):
    """Per-image PSNR and L1 of rendered images against uint8 ground
    truth, on the device."""
    pred = torch.clamp(imgs, 0.0, 1.0)
    gt = gt_u8.to(torch.float32) / 255.0
    ax = tuple(range(1, pred.dim()))
    mse = torch.mean((pred - gt) ** 2, dim=ax)
    return (-10.0 * torch.log10(torch.clamp(mse, min=1e-12)),
            torch.mean(torch.abs(pred - gt), dim=ax))


class Trainer:
    """End-to-end training of one scene on one device (see the module's
    docstring)."""

    rank, world = 0, 1

    def __init__(self, cfg: TrainConfig, scene, device=DEFAULT_DEVICE,
                 log_file=None):
        self.cfg = cfg
        self.scene = scene
        self.device = dev = resolve_device(device)
        self.log = log_file
        self.densify_count = 0
        self.densify_history: list = []   # one record per densification
        self.capacity_events: list = []   # (kind, new size)
        self.opacity_reset_iters: list = []
        self.timer = Timer(enabled=cfg.enable_timer, device=dev)
        # wall time of the last train() call with eval and saves paused
        self.end2end = End2endTimer()
        self._epoch_losses: list = []
        self._last_epoch = 0
        self._strategy_history: list = []
        self._pending_isects = None       # (count tensor, capacity) of a step
        self._isect_peak = 0.0
        self._isect_cap_current: Optional[int] = None
        self._densify_growth_ratio = 2.0
        self.isect_capacity_ceiling = ISECT_CAP_CEILING
        # (entry capacity, step bytes, ceiling) of each measured step
        self.hbm_readings: list = []
        self._hbm_usage_frac: Optional[float] = None
        self._ceiling_key = None          # the sizes the ceiling was read at
        self._peaks = (0, 0)              # allocated, reserved before a reset

        cam0 = scene.train_cameras[0]
        self.img_h, self.img_w = cam0.height, cam0.width
        self.spatial_lr_scale = scene.cameras_extent
        o = cfg.opt
        self.lrs, self.lr_scale = scaled_lrs(
            o.feature_lr, o.opacity_lr, o.scaling_lr, o.rotation_lr,
            bsz=cfg.dist.bsz, lr_scale_mode=o.lr_scale_mode,
            betas=o.adam_betas, eps=o.adam_eps,
            lr_scale_pos_and_scale=o.lr_scale_pos_and_scale)
        xyz_scale = (self.spatial_lr_scale * self.lr_scale
                     * o.lr_scale_pos_and_scale)
        self.xyz_sched = XyzLrSchedule(
            lr_init=o.position_lr_init * xyz_scale,
            lr_final=o.position_lr_final * xyz_scale,
            lr_delay_mult=o.position_lr_delay_mult,
            max_steps=o.position_lr_max_steps)
        if cfg.stop_update_param:
            # freeze every parameter: all learning rates 0
            self.lrs = self.lrs._replace(sh_dc=0.0, sh_rest=0.0, scales=0.0,
                                         quats=0.0, opacity=0.0)
            self.xyz_sched = XyzLrSchedule(0.0, 0.0, 1.0, 1)
        self.bg = torch.tensor(
            [1.0, 1.0, 1.0] if cfg.model.white_background else [0.0] * 3,
            dtype=torch.float32, device=dev)
        # whole images per rank when pixel sharding is off or each rank
        # draws its own cameras
        d = cfg.dist
        self._whole_image_division = self.world > 1 and (
            not d.image_distribution or d.local_sampling)

        self._init_model()
        self.dataset = SceneDataset(scene.train_cameras, seed=cfg.seed)
        if cfg.start_checkpoint:
            self._restore_tuner_state(cfg.start_checkpoint)

        # the training cameras, once, on the device; their ground truth too
        # where the dataset is preloaded, else it is uploaded each step
        cams = scene.train_cameras
        self._cam_bank = batch_camera_arrays(cams, dev)
        self._cam_index = {c.uid: i for i, c in enumerate(cams)}
        self._upload_gt = PinnedUpload(dev)
        self._gt_bank = (self._make_gt_bank(cams)
                         if self._apply_preload_rule() else None)

    def _apply_preload_rule(self) -> bool:
        """The JAX loop's dataset preload: with ``preload_dataset_to_gpu``,
        or a dataset (training and held-out views, 3 bytes a pixel) below
        ``preload_dataset_to_gpu_threshold`` GB, ``local_sampling`` and
        ``distributed_dataset_storage`` are switched off and the division
        recomputed (the reference's train_internal.py:133-155). Returns
        whether the dataset is preloaded: its ground truth then goes to
        the device once, else it stays on the host."""
        d, scene = self.cfg.dist, self.scene
        n_cams = len(scene.train_cameras) + len(scene.test_cameras)
        ds_gb = n_cams * self.img_h * self.img_w * 3 / 1e9
        thresh = d.preload_dataset_to_gpu_threshold
        if not (d.preload_dataset_to_gpu or (thresh > 0 and ds_gb < thresh)):
            return False
        if d.local_sampling:
            self._log("preload_dataset_to_gpu: disabling local_sampling "
                      "(ref train_internal.py:150-152)")
            d.local_sampling = False
            self._whole_image_division = (
                self.world > 1 and not d.image_distribution)
        d.distributed_dataset_storage = False
        self._log(f"preloaded {len(scene.train_cameras)} GT images "
                  f"({ds_gb:.2f} GB dataset) to device memory")
        return True

    def _point_cloud(self) -> PointCloud:
        """The scene's initial points, less a random share with
        ``drop_initial_3dgs_p`` (scaling runs)."""
        pcd, p = self.scene.point_cloud, self.cfg.drop_initial_3dgs_p
        if p > 0.0:
            rng = np.random.default_rng(self.cfg.seed)
            keep = rng.random(pcd.points.shape[0]) > p
            pcd = PointCloud(points=pcd.points[keep], colors=pcd.colors[keep])
        return pcd

    def _init_model(self):
        """The model, from the start checkpoint or the point cloud."""
        cfg, dev = self.cfg, self.device
        if cfg.start_checkpoint:
            self.state = load_checkpoint_sharded(
                cfg.start_checkpoint, 1,
                duplicate_coeff=cfg.drop_duplicate_gaussians_coeff,
                device=dev)
            n0 = int(self.state.alive.sum())
        else:
            pcd = self._point_cloud()
            n0 = pcd.points.shape[0]
            params, alive = init_from_pcd(
                pcd.points, pcd.colors,
                round_capacity(max(int(n0 * 1.5), 512)), cfg.model.sh_degree,
                device=dev)
            self.state = train_state_init(params, alive)
        self.capacity = self.state.alive.shape[0]
        # alive count feeding the pre-densify growth
        self._max_alive = n0
        self._log(f"init: {n0} gaussians, capacity {self.capacity}, image "
                  f"{self.img_w}x{self.img_h}, extent "
                  f"{self.spatial_lr_scale:.3f}, device {dev}")

    @property
    def _tiles_y(self) -> int:
        return -(-self.img_h // self.cfg.pipeline.tile_h)

    def _make_gt_bank(self, cams) -> torch.Tensor:
        """(C, 3, H, W) uint8 ground truth of the training cameras on the
        device (:func:`device_gt_bank`)."""
        return device_gt_bank(cams, self.img_h, self.device)

    def _batch_gt(self, batch: List[Camera], ids) -> torch.Tensor:
        """(B, 3, H, W) uint8 ground truth of the batch on the device:
        gathered from the bank (indices ``ids``), or packed on the host
        and uploaded."""
        if self._gt_bank is not None:
            return self._gt_bank[ids]

        def fill(buf):
            for b, c in enumerate(batch):
                buf[b] = c.gt()

        return self._upload_gt((len(batch), 3, self.img_h, self.img_w),
                               fill)

    # ------------------------------------------------------------------

    def _log(self, msg: str):
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        if not self.cfg.quiet and self.rank == 0:
            print(line, flush=True)
        if self.log is not None:
            self.log.write(line + "\n")
            self.log.flush()

    def _round_cap(self, target: float) -> int:
        """The mantissa-rounded entry capacity for ``target``, clamped to
        the entry ceiling (unrounded there, as in the JAX loop)."""
        cap = mantissa_round_cap(target, floor=ISECT_CAP_FLOOR,
                                 align=128 * max(1, self.cfg.dist.bsz))
        return min(cap, self.isect_capacity_ceiling)

    def _isect_cap(self) -> int:
        """Tile-list entries per batch: fixed until a grow."""
        if self._isect_cap_current is None:
            self._isect_cap_current = self._round_cap(
                self.cfg.pipeline.isect_capacity_factor * self.capacity)
        return self._isect_cap_current

    def render_config(self) -> RenderConfig:
        """The render shape of every step and eval batch: the batch's
        entry capacity split evenly over the training batch's cameras."""
        p = self.cfg.pipeline
        return RenderConfig(
            img_h=self.img_h, img_w=self.img_w, tile_w=p.tile_w,
            tile_h=p.tile_h,
            isect_capacity=self._isect_cap() // self.cfg.dist.bsz,
            max_per_tile=(p.max_per_tile if p.max_per_tile > 0
                          else 1024 * p.tile_w * p.tile_h // 256),
            chunk=p.chunk)

    def _check_isect_capacity(self, num_isects: int, cap: int):
        """Grow the entry capacity when a step's count passed 0.92 of the
        capacity it ran with, up to the ceiling; log a step that
        overflowed at the ceiling. A step of an older capacity only feeds
        the peak."""
        self._isect_peak = max(self._isect_peak, float(num_isects))
        if cap != self._isect_cap():
            return
        want = self._round_cap(1.15 * self._isect_peak)
        if num_isects > 0.92 * cap and want > cap:
            want = max(want, self._round_cap(1.35 * cap))
            self._isect_cap_current = want
            self.capacity_events.append(("isect_grow", want))
            self._log(f"isect near capacity ({num_isects}/{cap}): growing "
                      f"entry buffer -> {want}")
        elif num_isects > cap:
            self._log(f"isect over capacity ({num_isects}/{cap}) at the HBM "
                      f"ceiling; dropping farthest entries")

    def _padded_state(self, new: int) -> TrainState:
        """The state padded to ``new`` slots. New slots are dead; their
        Adam moments and densify statistics start at zero (the statistics
        are padded, not reset: a growth right before a densify keeps the
        round's gradients)."""
        st = self.state
        old = st.alive.shape[0]
        params, alive = pad_to_capacity(st.params, st.alive, new)

        def pad0(x):
            return torch.cat([x, x.new_zeros((new - old,) + x.shape[1:])])

        return TrainState(
            params=params, alive=alive,
            adam=AdamState(mu=GaussianParams(*map(pad0, st.adam.mu)),
                           nu=GaussianParams(*map(pad0, st.adam.nu)),
                           count=st.adam.count),
            stats=DensifyStats(*map(pad0, st.stats)),
            iteration=st.iteration)

    def _grow_capacity(self):
        """Double the Gaussian capacity."""
        old, new = self.capacity, 2 * self.capacity
        self.state = self._padded_state(new)
        self.capacity = new
        self.capacity_events.append(("capacity_grow", new))
        self._log(f"capacity grown: {old} -> {new}")

    def _split_noise(self, seed: int) -> torch.Tensor:
        """The standard-normal split offsets of one densify, (capacity,
        SPLIT_N, 3): the JAX package's draw from the key ``seed``."""
        return prng.normal(prng.key(seed), (self.capacity, SPLIT_N, 3),
                           self.device)

    def _measured_step(self, cap: int, step):
        """``step()``; on the first step at each entry capacity ``cap`` and
        Gaussian capacity, the entry ceiling from the memory it took."""
        key = (cap, self.capacity)
        if key == self._ceiling_key:
            return step()
        self._ceiling_key = key
        if self.device.type == "cuda":
            # the allocator's peaks go into the loop's running maxima, and
            # the step's own peak starts from what is live now
            self._peaks = self.peak_memory()
            torch.cuda.reset_peak_memory_stats(self.device)
        out = step()
        self._update_hbm_ceiling(cap, self._step_bytes())
        return out

    def peak_memory(self) -> Tuple[int, int]:
        """The most device memory allocated and reserved since the loop
        started (or since a reset of the caller's before it), across the
        resets of ``_measured_step``; (0, 0) on the CPU."""
        if self.device.type != "cuda":
            return 0, 0
        return (max(self._peaks[0],
                    torch.cuda.max_memory_allocated(self.device)),
                max(self._peaks[1],
                    torch.cuda.max_memory_reserved(self.device)))

    def _step_bytes(self) -> Optional[int]:
        """The peak device memory of the step just taken: the counterpart
        of XLA's temp + argument + output bytes of the JAX loop's compiled
        step. None on the CPU."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.max_memory_allocated(self.device)

    def _update_hbm_ceiling(self, cap: int, step_bytes: Optional[int]):
        """The entry ceiling from a step at entry capacity ``cap`` that
        took ``step_bytes`` (the JAX loop's method of the same name, and
        its log line): ``entry_ceiling`` over ``device_bytes_limit``. On
        the card a missing reading raises."""
        limit = device_bytes_limit(self.device)
        mine = None
        if step_bytes and limit:
            mine = entry_ceiling(cap, step_bytes, limit,
                                 self._bytes_per_entry())
        elif self.device.type == "cuda":
            raise RuntimeError(f"no memory reading on {self.device}: step "
                               f"bytes {step_bytes}, limit {limit}")
        ceiling = self._agreed_ceiling(mine)
        if mine is None:
            return
        self._hbm_usage_frac = step_bytes / limit
        self.isect_capacity_ceiling = ceiling
        self.hbm_readings.append((cap, step_bytes, ceiling))
        self._log(f"compiled step reserves {step_bytes / 2**30:.2f}GB of "
                  f"{limit / 2**30:.0f}GB HBM; isect entry ceiling -> "
                  f"{ceiling}")
        if mine == hbm.ENTRY_CAP_MAX:
            self._log(f"isect entry ceiling clamped to {mine}: entry "
                      f"offsets are int32")

    def _bytes_per_entry(self) -> float:
        """Device bytes a step takes per entry of capacity, for the lists
        this loop's step builds: the camera-blocked ones."""
        return hbm.BYTES_PER_ISECT_ENTRY

    def _agreed_ceiling(self, mine: Optional[int]) -> Optional[int]:
        """The ceiling every rank takes; on one device its own."""
        return mine

    def _step(self, cams, gt_u8, bg, sh_degree: int):
        """One training step of the loop's state."""
        o = self.cfg.opt
        return train_step(self.state, cams, gt_u8, bg, self.render_config(),
                          sh_degree, self.cfg.dist.bsz, o.lambda_dssim,
                          self.lrs, self.xyz_sched, o.lr_scale_mode,
                          o.lr_scale_loss,
                          self.cfg.dist.grad_normalization_mode)

    # ------------------------------------------------------------------

    def _render_eval(self, batch: List[Camera], sh_degree: int):
        with torch.no_grad():
            return render_batch(self.state.params, self.state.alive,
                                batch_camera_arrays(batch, self.device),
                                sh_degree, self.render_config(),
                                bg=self.bg)[0]

    def eval_psnr(self, cameras: List[Camera], sh_degree: int,
                  max_cams: Optional[int] = None) -> dict:
        """Mean L1 and PSNR of the model's renders of ``cameras`` against
        their ground truth, in batches of bsz (the last one at its exact
        size), with one readback at the end."""
        cams = cameras[:max_cams] if max_cams else cameras
        bsz = self.cfg.dist.bsz
        psnrs, l1s = [], []
        for i in range(0, len(cams), bsz):
            batch = cams[i:i + bsz]
            imgs = self._render_eval(batch, sh_degree)
            # read through: an eval sweep must not evict the training
            # working set from the decode cache
            gt = torch.as_tensor(
                np.stack([c.gt(cache=False) for c in batch]),
                device=self.device)
            p, l1 = _batched_psnr_l1(imgs, gt)
            psnrs.append(p)
            l1s.append(l1)
        psnr = torch.cat(psnrs).cpu().numpy()
        l1 = torch.cat(l1s).cpu().numpy()
        return {"psnr": float(np.mean(psnr)), "l1": float(np.mean(l1)),
                "n": len(psnr)}

    # ------------------------------------------------------------------

    def train(self, iterations: Optional[int] = None) -> TrainState:
        cfg, o = self.cfg, self.cfg.opt
        bsz = cfg.dist.bsz
        end = iterations if iterations is not None else o.iterations
        t_start = time.time()
        it = int(self.state.iteration)
        it0 = it                        # rates count this run's iterations
        # about 10 steps traced into <model_path>/trace, where the JAX
        # loop's jax.profiler trace falls (the reference's --nsys_profile)
        trace = Tracer(os.path.join(cfg.model.model_path, "trace"),
                       self.rank, self.device,
                       it + max(2 * bsz, 4) if cfg.nsys_profile else None,
                       10 * bsz)
        self.end2end = End2endTimer()
        self.end2end.start()
        while it < end:
            if trace.at(it):
                self._log(f"profiler trace written to {trace.directory}")
            sh_degree = min(it // 1000, cfg.model.sh_degree)
            metrics = self._train_step(it, sh_degree)
            if torch.is_anomaly_enabled() and not bool(
                    torch.isfinite(metrics["loss"])):
                raise FloatingPointError(
                    f"iter {it}: non-finite loss {float(metrics['loss'])} "
                    f"(autograd anomaly mode)")

            # the schedule fires on the pre-increment, 1-based iteration
            sched_it = it + 1
            it += bsz

            self._epoch_losses.append(metrics["loss"])
            if self.dataset.epoch != self._last_epoch:
                vals = torch.stack(self._epoch_losses).cpu().numpy()
                self._log(f"epoch {self._last_epoch} done at iter {it}: "
                          f"avg loss {np.mean(vals):.5f} ({len(vals)} steps)")
                self._epoch_losses = []
                self._last_epoch = self.dataset.epoch

            if it % cfg.log_interval < bsz:
                ips = (it - it0) / max(time.time() - t_start, 1e-9)
                self._log(f"iter {it}: loss={float(metrics['loss']):.5f} "
                          f"n3dgs={self._n_alive()} "
                          f"xyz_lr={float(metrics['xyz_lr']):.2e} "
                          f"it/s={ips:.2f}")
                if cfg.enable_timer:
                    self._log("timers: " + self.timer.report())

            if (not o.disable_auto_densification
                    and o.densify_from_iter < sched_it <= o.densify_until_iter
                    and check_update_at_this_iter(
                        sched_it, bsz, o.densification_interval, 0)
                    and not self._memory_guard_tripped()):
                self.timer.start("80 densify")
                self._densify(it, sched_it)
                self.timer.stop("80 densify")

            if (check_update_at_this_iter(sched_it, bsz,
                                          o.opacity_reset_interval, 0)
                    and sched_it + bsz <= o.opacity_reset_until_iter):
                self._reset_opacity()
                self.opacity_reset_iters.append(int(sched_it))
                self._log(f"iter {it}: opacity reset")

            # eval, save and checkpoint are kept out of the end-to-end time
            self.end2end.pause()
            if any(it - bsz < t <= it for t in cfg.test_iterations):
                self.timer.start("90 eval")
                self._run_eval(it, sh_degree)
                self.timer.stop("90 eval")
            if any(it - bsz < t <= it for t in cfg.save_iterations):
                self.save_model(it)
            if any(it - bsz < t <= it for t in cfg.checkpoint_iterations):
                self.save_checkpoint(it)
            self.end2end.start()
            if ((cfg.check_gpu_memory or cfg.check_cpu_memory
                 or cfg.log_memory_summary) and it % cfg.log_interval < bsz):
                self._log_memory(it)

        if trace.stop():
            self._log(f"profiler trace written to {trace.directory}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # the last step's time too
        self.end2end.pause()
        secs = time.time() - t_start
        self._log(f"training done: {it - it0} iters in {secs / 60:.2f} min "
                  f"({(it - it0) / max(secs, 1e-9):.2f} it/s)")
        if cfg.end2end_time:
            train_secs = self.end2end.total_seconds()
            self._log(f"end2end (excl. eval/save): {train_secs / 60:.2f} min "
                      f"({(it - it0) / max(train_secs, 1e-9):.2f} it/s)")
        if self._strategy_history and self.rank == 0:
            os.makedirs(cfg.model.model_path, exist_ok=True)
            path = os.path.join(cfg.model.model_path,
                                f"strategy_history_ws={self.world}.json")
            with open(path, "w") as f:
                json.dump(self._strategy_history, f)
            self._log(f"saved strategy history to {path}")
        return self.state

    def _next_batch(self) -> List[Camera]:
        """The next batch: with ``local_sampling`` from each rank's group
        of cameras (``uid % world``), else from the one stream."""
        bsz = self.cfg.dist.bsz
        if self.cfg.dist.local_sampling:
            return self.dataset.next_batch_grouped(bsz, self.world)
        return self.dataset.next_batch(bsz)

    def _record_division(self, it: int, batch, division_pos):
        """One step's entry of the strategy history, under the JAX loop's
        keys."""
        if self.cfg.dist.save_strategy_history:
            self._strategy_history.append({
                "iteration": it, "cameras": [c.uid for c in batch],
                "division_pos": [int(p) for p in division_pos]})

    def _train_step(self, it: int, sh_degree: int) -> dict:
        """Draw a batch and take one step; check the previous step's entry
        count. Returns the step's metrics."""
        bsz = self.cfg.dist.bsz
        self.timer.start("10 batch")
        batch = self._next_batch()
        ids = torch.tensor([self._cam_index[c.uid] for c in batch],
                           device=self.device)
        cams = type(self._cam_bank)(*(x[ids] for x in self._cam_bank))
        bg = self._background(it)
        self.timer.stop("10 batch")
        self.timer.start("20 ground truth")
        gt = self._batch_gt(batch, ids)
        self.timer.stop("20 ground truth")

        self.timer.start("50 step")
        cap = self._isect_cap()
        self.state, metrics = self._measured_step(
            cap, lambda: self._step(cams, gt, bg, sh_degree))
        self.timer.stop("50 step")
        # the whole batch is the one device's row span
        self._record_division(it, batch, [0, bsz * self._tiles_y])
        # the previous step's entry count, read now that this step is
        # queued behind it
        if self._pending_isects is not None:
            self._check_isect_capacity(int(self._pending_isects[0][0]),
                                       self._pending_isects[1])
        self._pending_isects = (metrics["num_isects"], cap)
        return metrics

    def _background(self, it: int) -> torch.Tensor:
        """The background of the step at iteration ``it``: with
        ``random_background`` JAX's draw from ``cfg.seed`` and ``it`` (the
        same on every rank), else the fixed one. The loops own the draw:
        the multi-rank loop's step leaves its own off."""
        if self.cfg.opt.random_background:
            return self._upload(prng.uniform_host(
                prng.fold_in(prng.key(self.cfg.seed), it), 3, 0.0, 1.0))
        return self.bg

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """``x`` on the device, copied from pinned memory behind the
        queued work: the host does not wait for the card here."""
        t = torch.as_tensor(x)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _n_alive(self) -> int:
        return int(self.state.alive.sum())

    def _reset_opacity(self):
        params, adam = reset_opacity(self.state.params, self.state.adam)
        self.state = self.state._replace(params=params, adam=adam)

    def _densify(self, it: int, sched_it: int):
        """One densify round: grow ahead by the last round's growth ratio,
        densify and prune, grow again if Gaussians were dropped or the
        largest shard filled past the trigger, then the subclass's
        follow-up (redistribution)."""
        o = self.cfg.opt
        while (self._densify_growth_ratio * self._max_alive
               > 0.92 * self.capacity):
            self._grow_capacity()
        prev_alive = self._max_alive
        info = self._densify_and_prune(it, sched_it)
        self.densify_count += 1
        clone, split, prune, dropped, alive = (int(info[:, k].sum())
                                               for k in range(5))
        new_max = int(info[:, 4].max())
        occ = new_max / self._shard_slots()
        self._densify_growth_ratio = float(np.clip(
            new_max / max(prev_alive, 1), 1.2, 3.2))
        self._max_alive = new_max
        self.densify_history.append({
            "iter": int(sched_it), "clone": clone, "split": split,
            "prune": prune, "alive": alive, "dropped": dropped})
        self._log(f"iter {it}: densify #{self.densify_count} "
                  f"clone={clone} split={split} prune={prune} alive={alive} "
                  f"dropped={dropped} max_occ={occ:.2f}")
        if dropped > 0 or occ > o.capacity_growth_trigger:
            self._grow_capacity()
        self._after_densify(it, info)

    def _densify_and_prune(self, it: int, sched_it: int) -> np.ndarray:
        """Densify and prune the state; returns the (D, 5) counts of every
        shard (``DensifyInfo``'s order; D = 1 here)."""
        o, st = self.cfg.opt, self.state
        params, alive, adam, stats, info_t = densify_and_prune(
            st.params, st.alive, st.adam, st.stats,
            self._split_noise(self.cfg.seed * 1000003 + it),
            o.densify_grad_threshold, o.min_opacity, self.spatial_lr_scale,
            o.percent_dense, sched_it > o.opacity_reset_interval)
        self.state = TrainState(params, alive, adam, stats, st.iteration)
        return info_t.cpu().numpy()[None]      # the round's one readback

    def _shard_slots(self) -> int:
        """The slots of one shard, the occupancy's denominator."""
        return self.capacity

    def _after_densify(self, it: int, info: np.ndarray):
        """What follows a densify round; nothing on one device."""

    def _memory_fraction(self) -> Optional[float]:
        """Share of the device's memory that live tensors take; where there
        is no such share (the CPU), the measured step's share of the
        device's memory, or None without a reading.

        The JAX package's guard divides live ``bytes_in_use`` by
        ``bytes_limit``; here the bytes the caching allocator has handed
        out (``torch.cuda.memory_allocated``) are divided by the card's
        total memory, which stands in for ``bytes_limit``. Blocks the
        allocator keeps cached, the CUDA context and other processes do
        not count."""
        if self.device.type != "cuda":
            return self._hbm_usage_frac
        total = torch.cuda.get_device_properties(self.device).total_memory
        return torch.cuda.memory_allocated(self.device) / total

    def _memory_guard_tripped(self) -> bool:
        """True, and logged, when the device's live memory passes
        ``densify_memory_limit_percentage``: densification stops."""
        return self._over_memory_limit(self._memory_fraction())

    def _over_memory_limit(self, frac: Optional[float]) -> bool:
        limit = self.cfg.opt.densify_memory_limit_percentage
        if frac is not None and frac > limit:
            self._log(f"densification stopped: HBM at {frac:.0%} "
                      f"(limit {limit:.0%})")
            return True
        return False

    def _log_memory(self, it: int):
        """The JAX loop's memory line, field for field: ``hbm_in_use`` and
        ``peak`` (--check_gpu_memory), ``cpu_maxrss`` (--check_cpu_memory)
        and ``compiled_reserved`` (--log_memory_summary). The port compiles
        no step, so ``compiled_reserved`` is the most the caching
        allocator has reserved on the card; both peaks are the loop's
        (``peak_memory``). The device fields are left out on the CPU."""
        cfg, gib = self.cfg, 2 ** 30
        on_card = self.device.type == "cuda"
        peak, reserved = self.peak_memory()
        parts = []
        if cfg.check_gpu_memory and on_card:
            parts.append(
                f"hbm_in_use="
                f"{torch.cuda.memory_allocated(self.device) / gib:.2f}GB "
                f"peak={peak / gib:.2f}GB")
        if cfg.check_cpu_memory:
            import resource

            rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            parts.append(f"cpu_maxrss={rss_kb / 2**20:.2f}GB")
        if cfg.log_memory_summary and on_card:
            parts.append(f"compiled_reserved={reserved / gib:.2f}GB")
        if parts:
            self._log(f"iter {it}: memory " + " ".join(parts))

    def _run_eval(self, it: int, sh_degree: int):
        for name, cams in (("test", self.scene.test_cameras),
                           ("train", self.scene.train_cameras[:8])):
            if not cams:
                continue
            r = self.eval_psnr(cams, sh_degree)
            self._log(f"iter {it}: eval {name}: L1={r['l1']:.5f} "
                      f"PSNR={r['psnr']:.3f} ({r['n']} cams)")

    def _distributed_io(self) -> bool:
        """Per-rank PLY and checkpoint files; never on one device."""
        return False

    def _whole_state(self) -> TrainState:
        """The whole model (on one device, the state itself)."""
        return self.state

    def save_model(self, it: int):
        out = os.path.join(self.cfg.model.model_path, "point_cloud",
                           f"iteration_{it}")
        os.makedirs(out, exist_ok=True)
        if self._distributed_io():
            save_ply(os.path.join(
                out, f"point_cloud_rk{self.rank}_ws{self.world}.ply"),
                self.state.params, self.state.alive)
            self._log(f"iter {it}: saved PLY shard {self.rank} to {out}")
            return
        whole = self._whole_state()
        if self.rank == 0:
            save_ply(os.path.join(out, "point_cloud.ply"), whole.params,
                     whole.alive)
            self._log(f"iter {it}: saved PLY to {out}")

    def _tuner_state(self) -> dict:
        """The loop's host-side capacity state, under the JAX package's
        keys (its other keys belong to the parts not ported)."""
        return {
            "n_devices": self.world,
            "isect_cap_current": self._isect_cap_current,
            "isect_peak": float(self._isect_peak),
            "densify_growth_ratio": float(self._densify_growth_ratio),
            "max_shard_alive": int(self._max_alive),
            "densify_count": int(self.densify_count),
        }

    def _restore_tuner_state(self, ckpt_dir: str):
        """Seed the capacity state from a checkpoint's tuner.json. Per-rank
        quantities (entry peaks, a shard's alive count) scale by saved D /
        D on an elastic resume."""
        saved = load_tuner_state(ckpt_dir)
        if not saved:
            return
        ratio = saved.get("n_devices", self.world) / self.world
        self._restore_tuner(saved, ratio)
        if saved.get("isect_cap_current"):
            self._isect_cap_current = min(mantissa_round_cap(
                saved["isect_cap_current"] * ratio, floor=ISECT_CAP_FLOOR,
                align=128 * max(1, self.cfg.dist.bsz)), hbm.ENTRY_CAP_MAX)
        self._densify_growth_ratio = float(
            saved.get("densify_growth_ratio", 2.0))
        self._max_alive = max(self._max_alive,
                              int(saved.get("max_shard_alive", 0) * ratio))
        self.densify_count = int(saved.get("densify_count", 0))
        self._log(f"tuner state restored from {ckpt_dir}: "
                  f"isect_cap={self._isect_cap_current} "
                  f"densify_count={self.densify_count}"
                  + (f" (rescaled x{ratio:.2f} for elastic resume)"
                     if ratio != 1.0 else ""))

    def _restore_tuner(self, saved: dict, ratio: float):
        """The subclass's own keys of the tuner state; here the entry
        peak."""
        self._isect_peak = float(saved.get("isect_peak", 0.0)) * ratio

    def save_checkpoint(self, it: int):
        out = os.path.join(self.cfg.model.model_path, "checkpoints", str(it))
        if self._distributed_io():
            save_checkpoint(out, self.state, rank=self.rank,
                            world_size=self.world)
            written = f"checkpoint shard {self.rank}"
        else:
            whole = self._whole_state()
            if self.rank == 0:
                save_checkpoint(out, whole, rank=0, world_size=1)
            written = "checkpoint"
        if self.rank == 0:
            save_tuner_state(out, self._tuner_state())
        self._log(f"iter {it}: saved {written} to {out}")
