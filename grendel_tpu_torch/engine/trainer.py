"""The host training loop on one GPU.

Counterpart of grendel_tpu/engine/trainer.py ``Trainer`` with one device
(the JAX package's replicated mode). Per block of ``bsz`` iterations:

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
densify statistics, it does not reset them), the densify noise seeded by
seed * 1000003 + iteration, the exact-size last eval batch, the per-epoch
loss log and the checkpoint's tuner state.

The tile-list entry capacity (per batch, ``RenderConfig.isect_capacity``
per camera) starts at isect_capacity_factor x capacity and grows to
max(1.15 x the largest entry count seen, 1.35 x itself), mantissa-rounded,
when a step's count passes 0.92 of it. The count is read one step late,
after the next step is queued, so no step waits on a readback; a count
over the capacity means that step dropped its farthest entries, and is
logged.

The ground truth goes up once as a uint8 bank on the device, as do the
training cameras; each step indexes both. With ``random_background`` the
background comes from the trainer's own generator seeded with
``cfg.seed``; the JAX package draws it from a JAX key, so the two differ.

Not ported, being TPU workarounds or multi-device paths: the recompile
generation tags, the blend-budget tuner (the render gets no post-cull
budget), the trainer cache, the HBM ceiling, the memory guard,
redistribution, whole-image division, local sampling, and host-side
ground-truth row packing. The options that select one of them raise.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..cameras import Camera, batch_camera_arrays
from ..config import TrainConfig, check_update_at_this_iter
from ..data.readers import PointCloud
from ..data.scene import SceneDataset
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.densify import (SPLIT_N, DensifyInfo, DensifyStats,
                              densify_and_prune, reset_opacity)
from ..models.gaussian_model import (GaussianParams, init_from_pcd,
                                     pad_to_capacity, round_capacity)
from ..models.optimizer import AdamState, scaled_lrs
from ..utils.hbm import mantissa_round_cap
from ..utils.timer import End2endTimer, Timer
from .checkpoint import (load_checkpoint_sharded, load_tuner_state,
                         save_checkpoint, save_tuner_state)
from .gaussian_io import save_ply
from .render import RenderConfig, render_batch
from .train import TrainState, XyzLrSchedule, train_state_init, train_step

ISECT_CAP_FLOOR = 1 << 14     # the entry capacity never goes below this


def _batched_psnr_l1(imgs: torch.Tensor, gt_u8: torch.Tensor):
    """Per-image PSNR and L1 of rendered images against uint8 ground
    truth, on the device."""
    pred = torch.clamp(imgs, 0.0, 1.0)
    gt = gt_u8.to(torch.float32) / 255.0
    ax = tuple(range(1, pred.dim()))
    mse = torch.mean((pred - gt) ** 2, dim=ax)
    return (-10.0 * torch.log10(torch.clamp(mse, min=1e-12)),
            torch.mean(torch.abs(pred - gt), dim=ax))


def check_ported(cfg: TrainConfig) -> None:
    """Raise on an option whose path the port does not have yet."""
    not_ported = {
        "dist.local_sampling": cfg.dist.local_sampling,
        "dist.save_strategy_history": cfg.dist.save_strategy_history,
        "dist.grad_normalization_mode":
            cfg.dist.grad_normalization_mode != "none",
        "nsys_profile": cfg.nsys_profile,
        "log_memory_summary": cfg.log_memory_summary,
    }
    on = [k for k, v in not_ported.items() if v]
    if on:
        raise NotImplementedError(f"not ported yet: {', '.join(on)}")


class Trainer:
    """End-to-end training of one scene on one device."""

    def __init__(self, cfg: TrainConfig, scene, device=DEFAULT_DEVICE,
                 log_file=None):
        check_ported(cfg)
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
        self._pending_isects = None       # (count tensor, capacity) of a step
        self._isect_peak = 0.0
        self._isect_cap_current: Optional[int] = None
        self._densify_growth_ratio = 2.0

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
        self._bg_gen = torch.Generator(device=dev).manual_seed(cfg.seed)

        if cfg.start_checkpoint:
            self.state = load_checkpoint_sharded(
                cfg.start_checkpoint, 1,
                duplicate_coeff=cfg.drop_duplicate_gaussians_coeff,
                device=dev)
            n0 = int(self.state.alive.sum())
        else:
            pcd = scene.point_cloud
            if cfg.drop_initial_3dgs_p > 0.0:
                # drop a random share of the initial points (scaling runs)
                rng = np.random.default_rng(cfg.seed)
                keep = (rng.random(pcd.points.shape[0])
                        > cfg.drop_initial_3dgs_p)
                pcd = PointCloud(points=pcd.points[keep],
                                 colors=pcd.colors[keep])
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

        self.dataset = SceneDataset(scene.train_cameras, seed=cfg.seed)
        if cfg.start_checkpoint:
            self._restore_tuner_state(cfg.start_checkpoint)

        # the training cameras and their ground truth, once, on the device
        cams = scene.train_cameras
        self._cam_bank = batch_camera_arrays(cams, dev)
        self._cam_index = {c.uid: i for i, c in enumerate(cams)}
        self._gt_bank = torch.as_tensor(
            np.stack([c.gt_image_u8 for c in cams]), device=dev)

    # ------------------------------------------------------------------

    def _log(self, msg: str):
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        if not self.cfg.quiet:
            print(line, flush=True)
        if self.log is not None:
            self.log.write(line + "\n")
            self.log.flush()

    def _round_cap(self, target: float) -> int:
        return mantissa_round_cap(target, floor=ISECT_CAP_FLOOR,
                                  align=128 * max(1, self.cfg.dist.bsz))

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

    def _check_isect_capacity(self, num_isects: int, cap: int, it: int):
        """Grow the entry capacity when a step's count passed 0.92 of the
        capacity it ran with; log an overflow."""
        self._isect_peak = max(self._isect_peak, float(num_isects))
        if num_isects > cap:
            self._log(f"iter {it}: isect overflow ({num_isects}/{cap}): the "
                      f"step dropped its farthest entries")
        want = self._round_cap(1.15 * self._isect_peak)
        if (num_isects > 0.92 * cap and want > cap
                and want > self._isect_cap()):
            want = max(want, self._round_cap(1.35 * cap))
            self._isect_cap_current = want
            self.capacity_events.append(("isect_grow", want))
            self._log(f"isect near capacity ({num_isects}/{cap}): growing "
                      f"entry buffer -> {want}")

    def _grow_capacity(self):
        """Double the Gaussian capacity. New slots are dead; their Adam
        moments and densify statistics start at zero (the statistics are
        padded, not reset: a growth right before a densify keeps the
        round's gradients)."""
        st = self.state
        old, new = self.capacity, 2 * self.capacity
        params, alive = pad_to_capacity(st.params, st.alive, new)

        def pad0(x):
            return torch.cat([x, x.new_zeros((new - old,) + x.shape[1:])])

        self.state = TrainState(
            params=params, alive=alive,
            adam=AdamState(mu=GaussianParams(*map(pad0, st.adam.mu)),
                           nu=GaussianParams(*map(pad0, st.adam.nu)),
                           count=st.adam.count),
            stats=DensifyStats(*map(pad0, st.stats)),
            iteration=st.iteration)
        self.capacity = new
        self.capacity_events.append(("capacity_grow", new))
        self._log(f"capacity grown: {old} -> {new}")

    def _split_noise(self, seed: int) -> torch.Tensor:
        """The standard-normal split offsets of one densify, (capacity,
        SPLIT_N, 3), from a generator seeded with ``seed``."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn((self.capacity, SPLIT_N, 3), generator=g,
                           device=self.device)

    def _step(self, cams, gt_u8, bg, sh_degree: int):
        """One training step of the loop's state."""
        o = self.cfg.opt
        return train_step(self.state, cams, gt_u8, bg, self.render_config(),
                          sh_degree, self.cfg.dist.bsz, o.lambda_dssim,
                          self.lrs, self.xyz_sched, o.lr_scale_mode,
                          o.lr_scale_loss)

    # ------------------------------------------------------------------

    def eval_psnr(self, cameras: List[Camera], sh_degree: int,
                  max_cams: Optional[int] = None) -> dict:
        """Mean L1 and PSNR of the model's renders of ``cameras`` against
        their ground truth, in batches of bsz (the last one at its exact
        size), with one readback at the end."""
        cams = cameras[:max_cams] if max_cams else cameras
        cfg, bsz = self.render_config(), self.cfg.dist.bsz
        psnrs, l1s = [], []
        for i in range(0, len(cams), bsz):
            batch = cams[i:i + bsz]
            with torch.no_grad():
                imgs, _, _ = render_batch(
                    self.state.params, self.state.alive,
                    batch_camera_arrays(batch, self.device), sh_degree, cfg,
                    bg=self.bg)
            gt = torch.as_tensor(np.stack([c.gt_image_u8 for c in batch]),
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
        self.end2end = End2endTimer()
        self.end2end.start()
        while it < end:
            sh_degree = min(it // 1000, cfg.model.sh_degree)
            self.timer.start("10 batch")
            batch = self.dataset.next_batch(bsz)
            ids = torch.tensor([self._cam_index[c.uid] for c in batch],
                               device=self.device)
            cams = type(self._cam_bank)(*(x[ids] for x in self._cam_bank))
            bg = (torch.rand(3, generator=self._bg_gen, device=self.device)
                  if o.random_background else self.bg)
            self.timer.stop("10 batch")

            self.timer.start("50 step")
            cap = self._isect_cap()
            self.state, metrics = self._step(cams, self._gt_bank[ids], bg,
                                             sh_degree)
            self.timer.stop("50 step")
            # the previous step's entry count, read now that this step is
            # queued behind it
            if self._pending_isects is not None:
                self._check_isect_capacity(int(self._pending_isects[0][0]),
                                           self._pending_isects[1], it)
            self._pending_isects = (metrics["num_isects"], cap)

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
                          f"n3dgs={int(self.state.alive.sum())} "
                          f"xyz_lr={float(metrics['xyz_lr']):.2e} "
                          f"it/s={ips:.2f}")
                if cfg.enable_timer:
                    self._log("timers: " + self.timer.report())
                if cfg.check_gpu_memory or cfg.check_cpu_memory:
                    self._log_memory(it)

            if (not o.disable_auto_densification
                    and o.densify_from_iter < sched_it <= o.densify_until_iter
                    and check_update_at_this_iter(
                        sched_it, bsz, o.densification_interval, 0)):
                self.timer.start("80 densify")
                self._densify(it, sched_it)
                self.timer.stop("80 densify")

            if (check_update_at_this_iter(sched_it, bsz,
                                          o.opacity_reset_interval, 0)
                    and sched_it + bsz <= o.opacity_reset_until_iter):
                params, adam = reset_opacity(self.state.params,
                                             self.state.adam)
                self.state = self.state._replace(params=params, adam=adam)
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
        return self.state

    def _densify(self, it: int, sched_it: int):
        """One densify round: grow ahead by the last round's growth ratio,
        densify and prune, grow again if Gaussians were dropped or the
        capacity filled past the trigger."""
        o = self.cfg.opt
        while (self._densify_growth_ratio * self._max_alive
               > 0.92 * self.capacity):
            self._grow_capacity()
        prev_alive = self._max_alive
        st = self.state
        params, alive, adam, stats, info_t = densify_and_prune(
            st.params, st.alive, st.adam, st.stats,
            self._split_noise(self.cfg.seed * 1000003 + it),
            o.densify_grad_threshold, o.min_opacity, self.spatial_lr_scale,
            o.percent_dense, sched_it > o.opacity_reset_interval)
        self.state = TrainState(params, alive, adam, stats, st.iteration)
        info = DensifyInfo(*info_t.tolist())      # the round's one readback
        self.densify_count += 1
        occ = info.n_alive / self.capacity
        self._densify_growth_ratio = float(np.clip(
            info.n_alive / max(prev_alive, 1), 1.2, 3.2))
        self._max_alive = info.n_alive
        self.densify_history.append({
            "iter": int(sched_it), "clone": info.n_cloned,
            "split": info.n_split, "prune": info.n_pruned,
            "alive": info.n_alive, "dropped": info.n_dropped})
        self._log(f"iter {it}: densify #{self.densify_count} "
                  f"clone={info.n_cloned} split={info.n_split} "
                  f"prune={info.n_pruned} alive={info.n_alive} "
                  f"dropped={info.n_dropped} max_occ={occ:.2f}")
        if info.n_dropped > 0 or occ > o.capacity_growth_trigger:
            self._grow_capacity()

    def _log_memory(self, it: int):
        parts = []
        if self.cfg.check_gpu_memory and self.device.type == "cuda":
            gib = 2 ** 30
            parts.append(
                f"device_in_use="
                f"{torch.cuda.memory_allocated(self.device) / gib:.2f}GB "
                f"peak={torch.cuda.max_memory_allocated(self.device) / gib:.2f}GB")
        if self.cfg.check_cpu_memory:
            import resource

            rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            parts.append(f"cpu_maxrss={rss_kb / 2**20:.2f}GB")
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

    def save_model(self, it: int):
        out = os.path.join(self.cfg.model.model_path, "point_cloud",
                           f"iteration_{it}")
        os.makedirs(out, exist_ok=True)
        save_ply(os.path.join(out, "point_cloud.ply"), self.state.params,
                 self.state.alive)
        self._log(f"iter {it}: saved PLY to {out}")

    def _tuner_state(self) -> dict:
        """The loop's host-side capacity state, under the JAX package's
        keys (its other keys belong to the parts not ported)."""
        return {
            "n_devices": 1,
            "isect_cap_current": self._isect_cap_current,
            "isect_peak": float(self._isect_peak),
            "densify_growth_ratio": float(self._densify_growth_ratio),
            "max_shard_alive": int(self._max_alive),
            "densify_count": int(self.densify_count),
        }

    def _restore_tuner_state(self, ckpt_dir: str):
        """Seed the capacity state from a checkpoint's tuner.json. A set
        written by n devices held per-device quantities, which scale by n
        on one device."""
        saved = load_tuner_state(ckpt_dir)
        if not saved:
            return
        ratio = float(saved.get("n_devices", 1))
        self._isect_peak = float(saved.get("isect_peak", 0.0)) * ratio
        if saved.get("isect_cap_current"):
            self._isect_cap_current = self._round_cap(
                saved["isect_cap_current"] * ratio)
        self._densify_growth_ratio = float(
            saved.get("densify_growth_ratio", 2.0))
        self._max_alive = max(self._max_alive,
                              int(saved.get("max_shard_alive", 0) * ratio))
        self.densify_count = int(saved.get("densify_count", 0))
        self._log(f"tuner state restored from {ckpt_dir}: "
                  f"isect_cap={self._isect_cap_current} "
                  f"densify_count={self.densify_count}")

    def save_checkpoint(self, it: int):
        out = os.path.join(self.cfg.model.model_path, "checkpoints", str(it))
        save_checkpoint(out, self.state, rank=0, world_size=1)
        save_tuner_state(out, self._tuner_state())
        self._log(f"iter {it}: saved checkpoint to {out}")
