"""Entry ``trainer_loop``: the user's training loop, ``Trainer`` as
``scripts/train.py`` builds it from the truck script's flags, on the
decoded JPEG views.

Set-up writes the dataset under ``TMPDIR`` (the committed truck JPEGs, the
structured rig's cameras and a point cloud drawn from the seed, as COLMAP),
loads it through the program's scene loader (JPEG decode; a resize on the
card where the ``-r`` rule resizes), and writes a checkpoint at
``start_images`` through the program's checkpoint writer: every point a
Gaussian as 3DGS initialises it, fresh Adam moments. Each segment of
``segment_images`` images resumes a new ``Trainer`` from that checkpoint,
as a user resumes a run, and trains it in chunks of ``chunk_steps``
steps; a faster program runs the same segments more often. Set-up runs
``warm_segments`` whole segments, then the window's own trainer through
its first three steps and on to ``densify_images``, past its first
densify round. Once the window has closed the reference follows the
three steps (losses, gradients, parameters, densify statistics) and
applies its own densify round to the state the program's round read.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import counts, scene
from ..reference import render as R
from ..reference import densify as D
from ..reference.compare import densify_numbers, stats_numbers, train_numbers
from ..reference.step import run_steps
from . import common

FIRST = 3
HERE = Path(__file__).resolve().parents[1]


def _bank(cfg: dict) -> dict:
    """The yardstick's record of the decoded views: each view's sha256 at
    the size the -r rule gives, and that size."""
    return json.loads((HERE / cfg["ground_truth"]).read_text())


class Cell:
    def __init__(self, cfg: dict, wl: dict, seed: int, device,
                 program: bool = True):
        self.cfg, self.wl, self.dev = cfg, wl, device
        common.build_kernels(device)
        self.tmp = tempfile.mkdtemp(prefix="gsbench-truck-")
        w0, h0 = cfg["image_size"]
        rig = scene.structured_rig(cfg["views"], w0, h0, cfg["fovx"])
        pts, cols = scene.structured_points(cfg["n_points"], seed)
        self.data = os.path.join(self.tmp, "truck")
        scene.write_colmap(self.data, rig, pts, cols)
        os.makedirs(os.path.join(self.data, "images"))
        for c in rig:
            shutil.copy(HERE / cfg["images"] / f"{c.name}.jpg",
                        os.path.join(self.data, "images"))
        self.train_names = [c.name for i, c in enumerate(rig)
                            if i % cfg["llffhold"]]
        self.extent = scene.camera_extent(
            [c for i, c in enumerate(rig) if i % cfg["llffhold"]])
        self.bank = _bank(cfg)
        self.w, self.h = self.bank["size"]
        self.cams = {c.name: scene.device_camera(
            c._replace(width=self.w, height=self.h), device) for c in rig}
        # the state at start_images: 3DGS's initialisation of the points
        p = torch.as_tensor(pts, device=device)
        n = p.shape[0]
        k = (cfg["sh_degree"] + 1) ** 2
        self.params0 = {
            "means3d": p,
            "sh_dc": ((torch.as_tensor(cols, device=device) - 0.5)
                      / scene.SH_C0)[:, None, :],
            "sh_rest": torch.zeros((n, k - 1, 3), device=device),
            "scales_raw": scene.knn_log_scales(p)[:, None].expand(n, 3)
            .contiguous(),
            "quats": torch.tensor([1.0, 0, 0, 0], device=device)
            .expand(n, 4).contiguous(),
            "opacities_raw": torch.full((n,), float(np.log(0.1 / 0.9)),
                                        device=device)}
        self.alive = torch.ones(n, dtype=torch.bool, device=device)
        self.n = n
        self.attempted = 0
        self.peak = 0
        if program:
            self._program()

    # -- the program ------------------------------------------------------

    def _argv(self, start_ckpt=None):
        c = self.cfg
        argv = ["-s", self.data, "-m", os.path.join(self.tmp, "model"),
                "--eval", "--llffhold", str(c["llffhold"]), "--iterations",
                str(c["iterations"]), "--bsz", str(c["bsz"]),
                "--test_iterations", str(c["iterations"]),
                "--save_iterations", str(c["iterations"]),
                "--resolution", str(c["resolution"]),
                "--device", str(self.dev), "-q"]
        if start_ckpt:
            argv += ["--start_checkpoint", start_ckpt]
        return argv

    def _program(self):
        from grendel_tpu_torch.engine.checkpoint import (save_checkpoint,
                                                         save_tuner_state)
        from grendel_tpu_torch.engine.train import train_state_init
        from grendel_tpu_torch.models.gaussian_model import GaussianParams
        from grendel_tpu_torch.scripts import train as cli

        self.cli = cli
        a = cli.build_parser().parse_args(self._argv())
        t0 = time.perf_counter()
        self.scene = cli.make_scene(a, self.dev)
        self.scene_load_s = time.perf_counter() - t0
        bank = self.bank["sha256"]
        self.gt = {}
        self.gt_mismatch = 0
        for c in self.scene.train_cameras + self.scene.test_cameras:
            arr = np.ascontiguousarray(c.gt())
            if hashlib.sha256(arr.tobytes()).hexdigest() != \
                    bank.get(f"{c.image_name}.jpg"):
                self.gt_mismatch += 1
            self.gt[c.image_name] = arr
        c, bsz = self.cfg, self.cfg["bsz"]
        self.ckpt = os.path.join(self.tmp, "start")
        state = train_state_init(
            GaussianParams(**{k: v.clone() for k, v in self.params0.items()}),
            self.alive.clone(), start_iteration=self.wl["start_images"])
        save_checkpoint(self.ckpt, state)
        peak = max(common.entry_count(self.params0, self.alive,
                                      self.cams[n], self.h, self.w,
                                      c["tile_w"], c["tile_h"], 0)
                   for n in self.train_names)
        save_tuner_state(self.ckpt, {
            "n_devices": 1,
            "isect_cap_current": common.mantissa_cap(
                1.15 * bsz * peak, align=128 * bsz),
            "isect_peak": float(bsz * peak), "densify_growth_ratio": 2.0,
            "max_shard_alive": self.n, "densify_count": 0})
        del state
        for _ in range(self.wl["warm_segments"]):
            tr = self._trainer()
            tr.train(self._end())
            self._retire(tr)
        # the window's trainer, its first steps recorded
        self.tr = self._trainer()
        rec = []
        orig = self.tr._step

        def step(*args):
            out = orig(*args)
            rec.append(out)
            return out

        self.tr._step = step
        self.tr.train(self.wl["start_images"] + FIRST * bsz)
        del self.tr._step
        b1 = self.tr.lrs.beta1
        self.losses = [float(m["loss"]) for _, m in rec]
        self.grads1 = {k: (v[:self.n] / (1 - b1)).cpu() for k, v in
                       common.leaves(rec[0][0].adam.mu).items()}
        self.params3 = {k: v[:self.n].cpu() for k, v in
                        common.leaves(rec[-1][0].params).items()}
        self.stats3 = [x[:self.n].cpu() for x in rec[-1][0].stats]
        del rec
        self._first_round()
        common.sync(self.dev)

    def _first_round(self):
        """Train the window's trainer through its first densify round and
        keep the state that the round read and the one it left."""
        tr, seen = self.tr, []
        orig = tr._densify_and_prune

        def round_(it, sched_it):
            before = _state_rows(tr.state)
            info = orig(it, sched_it)
            seen.append(dict(before=before, after=_state_rows(tr.state),
                             counts=info[0].tolist()[:4]
                             + [int(tr.state.alive.sum())], it=int(it),
                             sched_it=int(sched_it),
                             key=tr.cfg.seed * 1000003 + int(it)))
            return info

        tr._densify_and_prune = round_
        tr.train(self.wl["densify_images"])
        del tr._densify_and_prune
        if len(seen) != 1:
            raise RuntimeError(f"{len(seen)} densify rounds up to "
                               f"{self.wl['densify_images']} images, not 1")
        self.round = seen[0]

    def _trainer(self):
        from grendel_tpu_torch.engine.trainer_dist import make_trainer

        a = self.cli.build_parser().parse_args(self._argv(self.ckpt))
        return make_trainer(self.cli.args_to_config(a), self.scene,
                            device=self.dev)

    def _end(self) -> int:
        return self.wl["start_images"] + self.wl["segment_images"]

    def _retire(self, tr):
        """Fold a finished trainer's memory peaks into the run's."""
        if self.dev.type == "cuda":
            self.peak = max(self.peak, tr.peak_memory()[0])

    def window(self, seconds: float) -> dict:
        bsz, chunk = self.cfg["bsz"], self.wl["chunk_steps"] * self.cfg["bsz"]
        tr, images = self.tr, 0
        common.sync(self.dev)
        t0 = time.perf_counter()
        while True:
            it = int(tr.state.iteration)
            end = min(it + chunk, self._end())
            tr.train(end)
            images += end - it
            if end >= self._end():
                self._retire(tr)
                tr = self._trainer()
            if time.perf_counter() - t0 >= seconds:
                break
        common.sync(self.dev)
        t = time.perf_counter() - t0
        self._retire(tr)
        self.tr = None
        self.attempted = images // bsz
        self.note = f"{images} images in {t:.3f} s"
        return {"loop_images_per_s": images / t}

    def traced(self) -> dict:
        from .. import trace as T

        bsz, n = self.cfg["bsz"], self.wl["trace_steps"]
        self._retire(self.tr)
        tr = self._trainer()
        inputs, isects = [], []
        orig = tr._step

        def step(*args):
            inputs.append(tr.state)
            out = orig(*args)
            isects.append(out[1]["num_isects"])
            return out

        tr._step = step
        start = int(tr.state.iteration)
        trace = T.profile_window(lambda: tr.train(start + n * bsz))
        del tr._step
        self.attempted = n
        m = self.wl["sync_steps"]
        it = int(tr.state.iteration)
        syncs = T.count_syncs(lambda: tr.train(it + m * bsz))
        self._retire(tr)
        # the peak is the program's: the pair counts below are the
        # reference's work
        self.peak = self.peak_bytes()
        self.peak_read = True
        pixels = self.h * self.w
        fwd = bwd = ops = 0.0
        c = self.cfg
        for i, st in enumerate(inputs):
            deg = min((start + i * bsz) // 1000, c["sh_degree"])
            live = int(st.alive.sum())
            leaves = common.leaves(st.params)
            wk = bl = en = 0
            for name in self.train_names:
                with torch.no_grad():
                    s = R.project(leaves, st.alive, self.cams[name], self.h,
                                  self.w, deg)
                    lists = R.tile_lists(s, self.h, self.w, c["tile_w"],
                                         c["tile_h"])
                    _, w = R.render(s, lists, self.h, self.w, c["tile_w"],
                                    c["tile_h"], c["max_per_tile"],
                                    torch.zeros(3, device=self.dev))
                wk, bl, en = wk + w.walked, bl + w.blended, en + w.entries
            ns = leaves["means3d"].shape[0] * bsz
            fwd += counts.bound_s(*counts.blend_fwd_cost(wk, en, pixels * bsz,
                                                         ns))
            bwd += counts.bound_s(*counts.blend_bwd_cost(wk, bl, en,
                                                         pixels * bsz, ns))
            ops += counts.train_step_ops(wk, bl, pixels * bsz, bsz, live,
                                         deg, c["sh_degree"])
        return common.evidence(
            trace, "loop", n, images=n * bsz, blend_fwd_bound_s=fwd,
            blend_bwd_bound_s=bwd, ops=ops,
            entries_per_view=sum(int(x.reshape(-1)[0]) for x in isects)
            / len(isects) / bsz,
            syncs_per_step=syncs / m, scene_load_s=self.scene_load_s)

    def peak_bytes(self) -> int:
        if self.dev.type != "cuda" or getattr(self, "peak_read", False):
            return self.peak
        return max(self.peak, torch.cuda.max_memory_allocated(self.dev))

    # -- the reference ----------------------------------------------------

    def finish(self) -> dict:
        self.tr = self.scene = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = self.reference(torch.float32)
        out = train_numbers(self.losses, self.grads1, self.params3, ref,
                            {k: v.cpu() for k, v in self.params0.items()})
        out.update(stats_numbers(self.stats3, ref.stats))
        a = self.round["after"]
        out.update(densify_numbers(D.rows_of(a["p"], a["alive"], a["m"],
                                             a["v"]),
                                   self.round["counts"],
                                   self.reference_round(torch.float32)))
        out["gt_mismatch"] = float(self.gt_mismatch)
        shutil.rmtree(self.tmp, ignore_errors=True)
        return out

    def reference_round(self, dtype):
        """The reference's densify round on the state the program's first
        round read."""
        r, o, dev = self.round, self.cfg["optimizer"], self.dev
        b = r["before"]
        on = {t: {k: v.to(dev) for k, v in b[t].items()} for t in "pmv"}
        return D.densify(
            on["p"], b["alive"].to(dev), on["m"], on["v"],
            [x.to(dev) for x in b["stats"]],
            D.jax_normal(r["key"], (b["alive"].shape[0], 2, 3), dev),
            o["densify_grad_threshold"], o["min_opacity"], self.extent,
            o["percent_dense"], r["sched_it"] > o["opacity_reset_interval"],
            dtype)

    def reference(self, dtype, gt=None):
        c = self.cfg
        gt = self.gt if gt is None else gt
        cams = [self.cams[n] for n in self.train_names]
        gts = [torch.as_tensor(gt[n], device=self.dev)
               for n in self.train_names]
        spec = common.spec(c, self.h, self.w)
        return run_steps(self.params0, self.alive, [(cams, gts)] * FIRST,
                         torch.zeros(3, device=self.dev), spec,
                         common.optim(c, self.extent),
                         self.wl["start_images"],
                         lambda it: min(it // 1000, c["sh_degree"]), dtype)


def _state_rows(st) -> dict:
    """What a densify round reads and writes of a program's state, on the
    host: the leaves, Adam's moments, the statistics and the live mask."""
    out = {"alive": st.alive.cpu(),
           "stats": [x.cpu() for x in st.stats]}
    for tag, tree in (("p", st.params), ("m", st.adam.mu),
                      ("v", st.adam.nu)):
        out[tag] = {k: v.cpu() for k, v in common.leaves(tree).items()}
    return out


def readings(cfg: dict, wl: dict, seed: int, device, control: bool) -> dict:
    """The compared numbers of one seed without a window (no segment is
    warmed): the program's, or with ``control`` those of the reference in
    bfloat16 in its place."""
    wl = dict(wl, warm_segments=0)
    c = Cell(cfg, wl, seed, device)
    if not control:
        return c.finish()
    c.tr = c.scene = None
    low = c.reference(torch.bfloat16)
    ref = c.reference(torch.float32)
    out = train_numbers(
        low.losses, {k: v.float().cpu() for k, v in low.grads1.items()},
        {k: v.float().cpu() for k, v in low.params.items()}, ref,
        {k: v.cpu() for k, v in c.params0.items()})
    out.update(stats_numbers(low.stats, ref.stats))
    r = c.reference_round(torch.bfloat16)
    out.update(densify_numbers(r.rows, (r.clone, r.split, r.prune, 0,
                                        r.alive),
                               c.reference_round(torch.float32)))
    out["gt_mismatch"] = float(c.gt_mismatch)
    shutil.rmtree(c.tmp, ignore_errors=True)
    return out
