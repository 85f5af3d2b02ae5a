"""The host training loop of one rank of a torch.distributed group.

Counterpart of the multi-device half of grendel_tpu/engine/trainer.py
``Trainer``: one process per device (NCCL on the card, gloo on the CPU),
each driving parallel/sharded.py ``DistributedTrainer`` on its share of
the model. ``make_trainer`` builds this class when a process group exists
(at any world size), else the one-device ``Trainer``. Per block of ``bsz``
iterations:

  batch sampling (each rank draws the same batch from the same seed; with
  ``local_sampling`` group g of the cameras, ``uid % D == g``, fills rank
  g's share) -> the row division (``divide_rows`` over the per-camera
  heuristic history, or whole images when ``image_distribution`` is off or
  ``local_sampling`` on) -> this rank's ground-truth rows, gathered on its
  device from a preloaded bank, else packed on the host (only its own
  span, through ``Camera.gt``) and uploaded -> one distributed step ->
  the previous step's telemetry folded into the division history (after
  the warm-up) and the capacity tuner ->
  densify with capacity growth and random redistribution, opacity reset,
  on their schedule -> eval, saves and checkpoints, per rank when
  ``distributed_save`` is on.

With D > 1 and ``gaussians_distribution`` each rank holds a contiguous
shard of ``n_local`` slots; otherwise (and always at world size 1, as in
the JAX package) every rank holds the whole model.

Every host decision that leads to a collective reads values that are the
same on every rank: the batch (one seed), the division, the all-gathered
telemetry, the densify and redistribution info tables, the memory guard's
share after its maximum over ranks, the entry ceiling after its minimum
over ranks, and the schedule; so is the random background, which the
loop draws from ``cfg.seed`` and the iteration (``Trainer._background``)
and passes to a step whose ``ParallelConfig`` leaves the step's own draw
off: one draw a step, JAX's.

The capacity tuner keeps the JAX loop's thresholds and its generation
guard for each static size of ``ParallelConfig``: the tile-list entries
of a rank (from the ranks' largest ``num_isects``), the post-cull blend
budget (from ``num_kept``) and the all-to-all bucket ``send_cap`` (through
the bucket factor: grown on overflow, shrunk after 20 checks and one
window roll). The entry ceiling is the base loop's
(``Trainer._update_hbm_ceiling``), read on the first step of each entry
and Gaussian capacity from the rank's own step and taken as the smallest
over ranks: the JAX loop's D-device ``Trainer`` reads one compiled step
for all its devices. At D > 1 a rank's step builds the flat row-span
lists, and the ceiling counts their own bytes per entry
(``hbm.BYTES_PER_FLAT_ENTRY``). Evals render without the post-cull
budget, where the JAX loop's keep it (see ``_trainer_for_eval``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import native
from ..cameras import Camera, batch_camera_arrays
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.gaussian_model import (GaussianParams, init_from_pcd,
                                     round_capacity)
from ..parallel import comm
from ..parallel.division import (DivisionHistory, divide_rows,
                                 divide_rows_whole_images)
from ..parallel.redistribute import redistribute
from ..parallel.sharded import (DistributedTrainer, ParallelConfig,
                                shard_state)
from ..utils import hbm
from ..utils.timer import span
from .checkpoint import load_checkpoint_sharded
from .train import TrainState, train_state_init
from .trainer import Trainer, device_gt_bank

# shrink a size only when it is this many times its target
ISECT_SHRINK_GAP, BLEND_SHRINK_GAP = 2.0, 1.25


def make_trainer(cfg, scene, device=DEFAULT_DEVICE, log_file=None) -> Trainer:
    """The loop for this process: a ``MultiRankTrainer`` when a
    torch.distributed process group is initialized, else the one-device
    ``Trainer``."""
    cls = (MultiRankTrainer if dist.is_available() and dist.is_initialized()
           else Trainer)
    return cls(cfg, scene, device=device, log_file=log_file)


class MultiRankTrainer(Trainer):
    """Training of one scene by every rank of the default process group;
    each rank builds one with the same configuration and scene."""

    def __init__(self, cfg, scene, device=DEFAULT_DEVICE, log_file=None):
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        dev = resolve_device(device)
        nccl = dist.get_backend() == "nccl"
        if (dev.type == "cuda") != nccl:
            raise ValueError(f"a {dist.get_backend()} group trains on "
                             f"{'the card' if nccl else 'the CPU'}, not {dev}")
        if nccl:
            dev = torch.device("cuda", torch.cuda.current_device())
        d = cfg.dist
        self.sharded = d.gaussians_distribution and self.world > 1
        self._trainers: dict = {}
        self._eval_trainers: dict = {}
        self._pending = None            # the previous step's telemetry
        self._sh_degree = 0             # the SH degree of the last step
        self.redistribute_count = 0
        # the capacity tuner
        self._retune_gen = 0
        self._blend_cap_current: Optional[int] = None
        self._a2a_factor = 1.0
        self._peak_buckets = [0.0, 0.0]
        self._kept_buckets = [0.0, 0.0]
        self._a2a_buckets = [0.0, 0.0]
        self._kept_peak = self._a2a_peak = 0.0
        self._peak_window_start: Optional[int] = None
        self._window_rolls = 0
        self._isect_shrink_checks = self._blend_shrink_checks = 0
        self._a2a_shrink_checks = 0
        super().__init__(cfg, scene, dev, log_file)
        self.history = DivisionHistory(self._tiles_y, d.heuristic_decay)
        warm = d.adjust_strategy_warmp_iterations
        self.warmup_iters = len(scene.train_cameras) if warm < 0 else warm

    # -- set-up ---------------------------------------------------------------

    def _init_model(self):
        """The whole model, from the start checkpoint set (read for this
        world size) or the point cloud split into D capacity blocks, cut to
        this rank's share."""
        cfg, dev, n_dev = self.cfg, self.device, self.world
        if cfg.start_checkpoint:
            whole = load_checkpoint_sharded(
                cfg.start_checkpoint, n_dev,
                duplicate_coeff=cfg.drop_duplicate_gaussians_coeff,
                device=dev)
            n0 = int(whole.alive.sum())
            self.n_local = whole.alive.shape[0] // n_dev
        else:
            pcd = self._point_cloud()
            n0 = pcd.points.shape[0]
            self.n_local = round_capacity(max(int(n0 / n_dev * 1.5), 512))
            params, alive = init_from_pcd(
                pcd.points, pcd.colors, self.n_local * n_dev,
                cfg.model.sh_degree, n_shards=n_dev, device=dev)
            whole = train_state_init(params, alive)
        self.state = shard_state(whole, self.rank, n_dev, not self.sharded)
        self.capacity = self.state.alive.shape[0]     # this rank's slots
        # the largest shard's alive count, feeding the pre-densify growth
        self._max_alive = -(-n0 // n_dev) if self.sharded else n0
        self._log(f"init: {n0} gaussians, capacity {self.n_local}x{n_dev}, "
                  f"image {self.img_w}x{self.img_h}, extent "
                  f"{self.spatial_lr_scale:.3f}, device {dev}, rank "
                  f"{self.rank} of {n_dev}, "
                  f"{'sharded' if self.sharded else 'replicated'}")

    def _make_gt_bank(self, cams) -> torch.Tensor:
        """(C, 3, tiles_y, tile_h, W) uint8: the ground truth of the
        training cameras in tile rows, zero below the image
        (:func:`device_gt_bank`)."""
        th = self.cfg.pipeline.tile_h
        return device_gt_bank(cams, self._tiles_y * th, self.device).view(
            len(cams), 3, self._tiles_y, th, self.img_w)

    # -- the distributed step and its sizes -----------------------------------

    def _isect_cap_target(self) -> int:
        """1.15x the windowed peak of the ranks' entry counts; before any
        telemetry, isect_capacity_factor x n_local."""
        if self._isect_peak > 0:
            return self._round_cap(1.15 * self._isect_peak)
        return self._round_cap(self.cfg.pipeline.isect_capacity_factor
                               * self.n_local)

    def _isect_cap(self) -> int:
        if self._isect_cap_current is None:
            self._isect_cap_current = self._isect_cap_target()
        return self._isect_cap_current

    def _blend_cap(self) -> int:
        cap = self._isect_cap()
        cur = self._blend_cap_current
        return cap if cur is None else min(cur, cap)

    def _parallel_cfg(self, bsz: int, blend_capacity: int) -> ParallelConfig:
        p = self.cfg.pipeline
        # whole images need room for ceil(bsz / D) images of rows a rank
        n_row_slots = (-(-bsz // self.world) * self._tiles_y
                       if self._whole_image_division else 0)
        return ParallelConfig(
            n_devices=self.world, bsz=bsz, img_h=self.img_h,
            img_w=self.img_w, tile_w=p.tile_w, tile_h=p.tile_h,
            n_row_slots=n_row_slots, isect_capacity=self._isect_cap(),
            blend_capacity=blend_capacity,
            max_per_tile=(p.max_per_tile if p.max_per_tile > 0
                          else 1024 * p.tile_w * p.tile_h // 256),
            send_cap_factor=self._a2a_factor,
            gaussians_distribution=self.sharded).resolved(self.n_local)

    def _new_trainer(self, sh_degree: int, bsz: int,
                     blend_capacity: int) -> DistributedTrainer:
        o = self.cfg.opt
        return DistributedTrainer(
            self._parallel_cfg(bsz, blend_capacity), sh_degree,
            o.lambda_dssim, self.lrs,
            self.xyz_sched, o.lr_scale_mode, o.lr_scale_loss,
            self.cfg.dist.grad_normalization_mode)

    def _trainer(self, sh_degree: int) -> DistributedTrainer:
        """The step of the current sizes, kept until a size changes."""
        key = (sh_degree, self.n_local, self._isect_cap(), self._blend_cap(),
               self._a2a_factor)
        if key not in self._trainers:
            self._trainers[key] = self._new_trainer(
                sh_degree, self.cfg.dist.bsz, self._blend_cap())
        return self._trainers[key]

    def _trainer_for_eval(self, sh_degree: int, bsz: int):
        """The render of an eval batch at its exact size, without the
        post-cull budget: the budget follows the training steps' kept
        entries one step late, and an eval right after a densify would
        outgrow it and drop entries (the JAX loop's eval keeps it)."""
        key = (sh_degree, self.n_local, self._isect_cap(), self._a2a_factor,
               bsz)
        if key not in self._eval_trainers:
            self._eval_trainers[key] = self._new_trainer(sh_degree, bsz, 0)
        return self._eval_trainers[key]

    def _division(self, batch: List[Camera], pcfg: ParallelConfig):
        """division_pos (D + 1,) of the batch's tile rows."""
        if self._whole_image_division:
            return divide_rows_whole_images(pcfg.bsz, self._tiles_y,
                                            self.world)
        return divide_rows(self.history.heuristic_for(batch), self.world,
                           pcfg.n_row_slots, rows_per_image=self._tiles_y,
                           border_coeff=self.cfg.dist.border_divpos_coeff)

    def _gt_rows(self, batch: List[Camera], ids, pos_np: np.ndarray,
                 pcfg: ParallelConfig) -> torch.Tensor:
        """This rank's (R, 3, tile_h, W) uint8 ground-truth rows of
        ``batch`` (bank indices ``ids``) at the division ``pos_np``, zero
        past its span: gathered on the device from a preloaded bank, else
        packed on the host by ``native.pack_gt_rows`` (threaded C with the
        contract of parallel/division.py ``pack_gt_rows``) over this
        rank's span alone (a lazily stored camera decodes only where its
        rows are this rank's) and uploaded. Both give the same bytes."""
        lo, hi = int(pos_np[self.rank]), int(pos_np[self.rank + 1])
        shape = (pcfg.n_row_slots, 3, pcfg.tile_h, self.img_w)
        if self._gt_bank is None:
            span = np.array([lo, hi], np.int32)
            return self._upload_gt(shape, lambda buf: native.pack_gt_rows(
                batch, span, 1, pcfg.n_row_slots, pcfg.tile_h, self.img_h,
                self.img_w, out=buf[None]))
        rows = lo + torch.arange(pcfg.n_row_slots, device=self.device)
        b = torch.clamp(rows // self._tiles_y, 0, pcfg.bsz - 1)
        out = self._gt_bank[ids[b], :, rows % self._tiles_y]
        keep = (rows < hi)[:, None, None, None]
        return torch.where(keep, out, torch.zeros_like(out))

    def _step(self, cams, gt_rows, bg, sh_degree: int, division_pos):
        """One distributed step of this rank's state."""
        return self._trainer(sh_degree).step(self.state, cams, gt_rows,
                                             division_pos, bg)

    def _train_step(self, it: int, sh_degree: int) -> dict:
        d = self.cfg.dist
        self._sh_degree = sh_degree
        pcfg = self._trainer(sh_degree).cfg
        with span("10 division+pack", timer=self.timer):
            batch = self._next_batch()
            pos_np = self._division(batch, pcfg)
            ids = self._upload(np.array([self._cam_index[c.uid]
                                         for c in batch]))
            pos = self._upload(pos_np)
            cams = type(self._cam_bank)(*(x[ids] for x in self._cam_bank))
            with span("20 ground truth", timer=self.timer):
                gt_rows = self._gt_rows(batch, ids, pos_np, pcfg)

        with span("50 step", timer=self.timer):
            bg = self._background(it)
            self.state, metrics = self._measured_step(
                pcfg.isect_capacity,
                lambda: self._step(cams, gt_rows, bg, sh_degree, pos))
        self._record_division(it, batch, pos_np)
        # the previous step's telemetry, on the host by now: no step waits
        # for its own
        if self._pending is not None:
            with span("capacity check"):
                self._fold_telemetry(it)
        want_history = (not d.no_heuristics_update
                        and not self._whole_image_division
                        and self.world > 1 and it >= self.warmup_iters)
        self._pending = (batch if want_history else None, pos_np,
                         *self._to_host_later(metrics["telemetry"],
                                              metrics["per_row_entries"]),
                         pcfg, self._retune_gen)
        return metrics

    def _to_host_later(self, *tensors):
        """Start copying ``tensors`` to the host behind the queued work.
        Returns the copies and an event to wait on (None on the CPU)."""
        if self.device.type != "cuda":
            return tensors, None
        host = tuple(t.to("cpu", non_blocking=True) for t in tensors)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _fold_telemetry(self, it: int):
        batch, pos_np, (tel, per_row), done, pcfg, gen = self._pending
        if done is not None:
            done.synchronize()
        if batch is not None:
            self.history.update(batch, pos_np, per_row.numpy())
        self._check_capacity_telemetry(tel.numpy(), pcfg, gen, it)

    # -- the capacity tuner ---------------------------------------------------

    def _retune(self):
        """Drop the steps of the old sizes; telemetry of an older
        generation no longer drives a decision."""
        self._trainers.clear()
        self._eval_trainers.clear()
        self._retune_gen += 1
        self._window_rolls = 0

    def _check_capacity_telemetry(self, tel: np.ndarray, pcfg, gen: int,
                                  it: int):
        """Fold one step's (num_isects | a2a_overflow | a2a_demand |
        num_kept) of every rank into the windowed peaks (two buckets of an
        epoch each) and resize what they outgrew or what sits oversized;
        a step of an older generation only feeds the peaks."""
        d = tel.shape[0] // 4
        num_isects = int(tel[:d].max())
        overflow = int(tel[d:2 * d].sum())
        a2a_demand = int(tel[2 * d:3 * d].max())
        num_kept = int(tel[3 * d:].max())
        window = max(self.dataset.epoch_len, 50)
        if self._peak_window_start is None:
            self._peak_window_start = it
        if it - self._peak_window_start >= window:
            self._peak_buckets = [self._peak_buckets[1], 0.0]
            self._a2a_buckets = [self._a2a_buckets[1], 0.0]
            self._kept_buckets = [self._kept_buckets[1], 0.0]
            self._peak_window_start = it
            self._window_rolls += 1
        self._peak_buckets[1] = max(self._peak_buckets[1], float(num_isects))
        self._isect_peak = max(self._peak_buckets)
        self._a2a_buckets[1] = max(self._a2a_buckets[1], float(a2a_demand))
        self._a2a_peak = max(self._a2a_buckets)
        self._kept_buckets[1] = max(self._kept_buckets[1], float(num_kept))
        self._kept_peak = max(self._kept_buckets)
        if gen != self._retune_gen:
            return
        want = self._isect_cap_target()
        if (num_isects > 0.92 * pcfg.isect_capacity
                and want > pcfg.isect_capacity and want > self._isect_cap()):
            # overshoot (1.35x at least) bounds the grows logarithmically
            want = max(want, self._round_cap(1.35 * pcfg.isect_capacity))
            self._isect_cap_current = want
            if num_isects > pcfg.isect_capacity:
                # an overflow capped the kept counts: learn them again
                self._blend_cap_current = None
                self._kept_buckets = [0.0, 0.0]
                self._kept_peak = 0.0
            else:
                self._refresh_blend_cap()
            self._retune()
            self._isect_shrink_checks = 0
            self.capacity_events.append(("isect_grow", want))
            self._log(f"isect near capacity ({num_isects}/"
                      f"{pcfg.isect_capacity}): growing entry buffer -> "
                      f"{want}")
        elif num_isects > pcfg.isect_capacity:
            self._log(f"isect over capacity ({num_isects}/"
                      f"{pcfg.isect_capacity}) at the HBM ceiling; dropping "
                      f"farthest entries")
        elif (want < pcfg.isect_capacity / ISECT_SHRINK_GAP
                and want < self._isect_cap()):
            # shrink only after every camera of a window was seen
            self._isect_shrink_checks += 1
            if self._isect_shrink_checks >= 20 and self._window_rolls >= 1:
                self._isect_cap_current = want
                self._refresh_blend_cap()
                self._retune()
                self._isect_shrink_checks = 0
                self.capacity_events.append(("isect_shrink", want))
                self._log(f"isect capacity oversized ({num_isects}/"
                          f"{pcfg.isect_capacity}): shrinking entry buffer "
                          f"-> {want}")
        else:
            self._isect_shrink_checks = 0
        self._check_blend_telemetry(num_kept, pcfg)
        if overflow > 0:
            # straight to the demand seen (the largest bucket's true count)
            self._a2a_factor = max(self._a2a_factor * 1.5,
                                   1.3 * a2a_demand / max(self.n_local, 1))
            self._a2a_shrink_checks = 0
            self._retune()
            self.capacity_events.append(("a2a_grow", self._a2a_factor))
            self._log(f"a2a bucket overflow ({overflow} entries, demand "
                      f"{a2a_demand}): raising send_cap_factor -> "
                      f"{self._a2a_factor:.2f}")
        elif self._a2a_factor > 1.0 and a2a_demand > 0:
            want_f = max(1.3 * self._a2a_peak / max(self.n_local, 1), 1.0)
            if want_f < self._a2a_factor / 2.0:
                self._a2a_shrink_checks += 1
                if self._a2a_shrink_checks >= 20 and self._window_rolls >= 1:
                    self._a2a_factor = want_f
                    self._a2a_shrink_checks = 0
                    self._retune()
                    self.capacity_events.append(("a2a_shrink", want_f))
                    self._log(f"a2a buckets oversized (windowed demand peak "
                              f"{self._a2a_peak:.0f} vs cap "
                              f"{pcfg.send_cap}): send_cap_factor -> "
                              f"{want_f:.2f}")
            else:
                self._a2a_shrink_checks = 0

    def _refresh_blend_cap(self):
        """The blend budget from the windowed kept peak, at an entry
        resize."""
        if self._kept_peak > 0:
            self._blend_cap_current = min(
                self._round_cap(1.15 * self._kept_peak), self._isect_cap())

    def _check_blend_telemetry(self, num_kept: int, pcfg):
        """Grow the post-cull blend budget when the kept entries pass 0.92
        of it; shrink it to 1.15x the kept peak when 1.25x oversized (after
        20 checks and a window roll)."""
        blend_cur = self._blend_cap()
        want = blend_cur
        if self._kept_peak > 0:
            want = min(self._round_cap(1.15 * self._kept_peak),
                       self._isect_cap())
        if (num_kept > 0.92 * pcfg.blend_capacity
                and pcfg.blend_capacity < pcfg.isect_capacity
                and want > blend_cur):
            want = min(max(want, self._round_cap(1.35 * pcfg.blend_capacity)),
                       self._isect_cap())
            self._blend_cap_current = want
            self._retune()
            self._blend_shrink_checks = 0
            self.capacity_events.append(("blend_grow", want))
            self._log(f"post-cull entries near blend budget ({num_kept}/"
                      f"{pcfg.blend_capacity}): growing -> {want}")
        elif (want < pcfg.blend_capacity / BLEND_SHRINK_GAP
                and want < blend_cur):
            self._blend_shrink_checks += 1
            if self._blend_shrink_checks >= 20 and self._window_rolls >= 1:
                self._blend_cap_current = want
                self._retune()
                self._blend_shrink_checks = 0
                self.capacity_events.append(("blend_shrink", want))
                self._log(f"post-cull blend budget oversized ({num_kept}/"
                          f"{pcfg.blend_capacity}): compacting -> {want}")
        else:
            self._blend_shrink_checks = 0

    # -- densify, growth, redistribution -------------------------------------

    def _grow_capacity(self):
        """Double n_local: each rank pads its own shard by n_local slots
        (the whole axis by n_local x D when replicated)."""
        old = self.n_local
        self.capacity += old if self.sharded else old * self.world
        self.state = self._padded_state(self.capacity)
        self.n_local = 2 * old
        self._retune_gen += 1
        self._eval_trainers.clear()
        self.capacity_events.append(("capacity_grow", self.n_local))
        self._log(f"capacity grown: {old} -> {self.n_local} per shard")

    def _densify_and_prune(self, it: int, sched_it: int) -> np.ndarray:
        o = self.cfg.opt
        self.state, info_t = self._trainer(self._sh_degree).densify(
            self.state, self.cfg.seed * 1000003 + it, o.densify_grad_threshold,
            o.min_opacity, self.spatial_lr_scale, o.percent_dense,
            sched_it > o.opacity_reset_interval)
        return info_t.cpu().numpy()         # (D, 5), the round's readback

    def _shard_slots(self) -> int:
        return self.n_local

    def _after_densify(self, it: int, info: np.ndarray):
        """The redistribution schedule: every ``frequency`` rounds, the
        first always, later ones when the shards' alive counts are further
        apart than the threshold."""
        d = self.cfg.dist
        freq = d.redistribute_gaussians_frequency
        if (self.sharded and d.redistribute_gaussians_mode
                == "random_redistribute" and self.densify_count % freq == 0):
            alive = info[:, 4].astype(np.int64)
            if (self.densify_count == freq or alive.min()
                    * d.redistribute_gaussians_threshold < alive.max()):
                self._redistribute(it)

    def _redistribute(self, it: int):
        """One random redistribution; if a rank dropped received rows, the
        round is thrown away and the capacity grows."""
        st = self.state
        params, alive, adam, info_t = redistribute(
            st.params, st.alive, st.adam, it,
            max(256, 2 * self.n_local // self.world))
        info = info_t.cpu().numpy()
        if info[:, 2].sum() > 0:
            self._log(f"iter {it}: redistribution dropped "
                      f"{info[:, 2].sum()} — growing capacity and skipping")
            self._grow_capacity()
            return
        self.state = st._replace(params=params, alive=alive, adam=adam)
        self.redistribute_count += 1
        self._log(f"iter {it}: redistributed {info[:, 0].sum()} gaussians")

    def _reset_opacity(self):
        self.state = self._trainer(self._sh_degree).reset_opacity(self.state)

    def _n_alive(self) -> int:
        n = self.state.alive.sum()
        if self.sharded:
            n, = comm.all_reduce_sum([n])
        return int(n)

    def _bytes_per_entry(self) -> float:
        """A rank's bytes per entry of capacity: the camera-blocked lists'
        at world size 1 (the replicated payload, parallel/sharded.py
        render_owned_rows), the flat row-span lists' at D > 1."""
        if self.world == 1:
            return hbm.BYTES_PER_ISECT_ENTRY
        return hbm.BYTES_PER_FLAT_ENTRY

    def _agreed_ceiling(self, mine: Optional[int]) -> Optional[int]:
        """The smallest ceiling over ranks (None where no rank read one):
        every rank clamps its capacities alike, or a rank that grew alone
        would hang the others in their next collective."""
        none = 1 << 53              # exact in all_reduce_min's float64
        low, = comm.all_reduce_min([torch.tensor(
            none if mine is None else mine, dtype=torch.int64,
            device=self.device)])
        return None if int(low) == none else int(low)

    def _memory_guard_tripped(self) -> bool:
        """The guard on the largest share over ranks: a densify round is
        collective, so every rank takes the same branch."""
        frac = self._memory_fraction()
        top, = comm.all_reduce_max([torch.tensor(
            -1.0 if frac is None else frac, device=self.device)])
        return self._over_memory_limit(None if top < 0 else float(top))

    # -- eval and I/O ---------------------------------------------------------

    def _render_eval(self, batch: List[Camera], sh_degree: int):
        """The batch's images rendered by every rank's rows (an even
        division), the same on every rank."""
        trainer = self._trainer_for_eval(sh_degree, len(batch))
        pcfg = trainer.cfg
        pos = torch.as_tensor(divide_rows(
            np.ones(pcfg.total_rows), self.world, pcfg.n_row_slots),
            device=self.device)
        return trainer.render(self.state.params, self.state.alive,
                              batch_camera_arrays(batch, self.device), pos,
                              self.bg)

    def _distributed_io(self) -> bool:
        """Per-rank files: ``distributed_save`` with a sharded model."""
        return self.cfg.dist.distributed_save and self.sharded

    def _whole_state(self) -> TrainState:
        """The whole model on every rank: the shards gathered in rank
        order, or the rank's own copy when replicated."""
        if not self.sharded:
            return self.state

        def whole(x):
            if x.dtype == torch.bool:
                return whole(x.to(torch.uint8)).to(torch.bool)
            return comm.all_gather(x).reshape((-1,) + x.shape[1:])

        st = self.state
        return TrainState(
            params=GaussianParams(*map(whole, st.params)),
            alive=whole(st.alive),
            adam=st.adam._replace(mu=GaussianParams(*map(whole, st.adam.mu)),
                                  nu=GaussianParams(*map(whole, st.adam.nu))),
            stats=type(st.stats)(*map(whole, st.stats)),
            iteration=st.iteration)

    def _tuner_state(self) -> dict:
        """The JAX loop's tuner state, every key of it."""
        return {**super()._tuner_state(),
                "blend_cap_current": self._blend_cap_current,
                "kept_peak": float(self._kept_peak),
                "a2a_factor": float(self._a2a_factor),
                "a2a_peak": float(self._a2a_peak)}

    def _restore_tuner(self, saved: dict, ratio: float):
        """The windowed peaks (trusted until a whole window after the
        resume rolls them out), the blend budget and the bucket factor."""
        if saved.get("isect_peak", 0) > 0:
            self._isect_peak = saved["isect_peak"] * ratio
            self._peak_buckets = [self._isect_peak] * 2
            self._peak_window_start = int(self.state.iteration)
        if saved.get("kept_peak", 0) > 0:
            self._kept_peak = saved["kept_peak"] * ratio
            self._kept_buckets = [self._kept_peak] * 2
        if saved.get("blend_cap_current"):
            self._blend_cap_current = self._round_cap(
                saved["blend_cap_current"] * ratio)
        self._a2a_factor = float(saved.get("a2a_factor", 1.0))
        if saved.get("a2a_peak", 0) > 0:
            self._a2a_peak = float(saved["a2a_peak"]) * ratio
            self._a2a_buckets = [self._a2a_peak] * 2
