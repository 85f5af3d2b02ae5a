"""Entry ``train_step``: the program's training step
(``grendel_tpu_torch.engine.train.train_step``) called back to back.

Traffic (the cell's file): ``views`` orbit cameras at ``distance``, each
with random uint8 ground truth, all drawn from the seed; segments of
``segment`` steps, each from the same initial state, step ``i`` of a
segment on view ``i mod views``. A faster program repeats the same
segments more often; it is never given other work.

Set-up builds the state and runs the segment's first three steps through
the same call; the reference follows those three steps from the same
initial parameters once the window has closed.
"""

from __future__ import annotations

import time

import torch

from .. import counts, scene
from ..reference import render as R
from ..reference.compare import train_numbers
from ..reference.step import run_steps
from . import common

FIRST = 3    # steps the reference follows


class Cell:
    def __init__(self, cfg: dict, wl: dict, seed: int, device,
                 program: bool = True):
        self.cfg, self.wl, self.dev = cfg, wl, device
        common.build_kernels(device)
        gen = common.generator(seed, device)
        self.h, self.w = cfg["height"], cfg["width"]
        self.params0, self.alive = scene.garden_gaussians(
            cfg["n_live"], cfg["capacity"], cfg["extent"],
            tuple(cfg["log_scale"]), tuple(cfg["opacity"]), cfg["sh_degree"],
            gen)
        self.hosts = [scene.orbit_camera(self.w, self.h, wl["distance"], a)
                      for a in scene.orbit_angles(wl["views"], gen)]
        self.gts = scene.random_images(wl["views"], self.h, self.w, gen)
        self.cams = [scene.device_camera(c, device) for c in self.hosts]
        self.bg = torch.zeros(3, device=device)
        cap = max(common.entry_count(self.params0, self.alive, c, self.h,
                                     self.w, cfg["tile_w"], cfg["tile_h"],
                                     cfg["sh_degree"]) for c in self.cams)
        self.isect_cap = common.mantissa_cap(1.15 * cap)
        self.attempted = 0
        if program:
            self._program()

    # -- the program ------------------------------------------------------

    def _program(self):
        from grendel_tpu_torch.engine import train as T
        from grendel_tpu_torch.engine.render import RenderConfig
        from grendel_tpu_torch.models.gaussian_model import GaussianParams
        from grendel_tpu_torch.models.optimizer import scaled_lrs

        cfg, o = self.cfg, self.cfg["optimizer"]
        self.T = T
        self.rcfg = RenderConfig(
            img_h=self.h, img_w=self.w, tile_w=cfg["tile_w"],
            tile_h=cfg["tile_h"], isect_capacity=self.isect_cap,
            max_per_tile=cfg["max_per_tile"])
        self.lrs, s = scaled_lrs(o["feature_lr"], o["opacity_lr"],
                                 o["scaling_lr"], o["rotation_lr"],
                                 bsz=cfg["bsz"], lr_scale_mode="sqrt")
        self.sched = T.XyzLrSchedule(
            o["position_lr_init"] * s * cfg["spatial_lr_scale"],
            o["position_lr_final"] * s * cfg["spatial_lr_scale"],
            o["position_lr_delay_mult"], o["position_lr_max_steps"])
        self.pcams = [common.program_camera(c, self.dev) for c in self.hosts]
        self.state0 = T.train_state_init(
            GaussianParams(**{k: v.clone() for k, v in self.params0.items()}),
            self.alive)
        # the segment's first steps, through the window's own call
        st, losses = self.state0, []
        for i in range(FIRST):
            st, m = self._step(st, i)
            losses.append(m["loss"])
            if i == 0:
                b1 = self.lrs.beta1
                self.grads1 = {k: (v / (1 - b1)).cpu() for k, v in
                               common.leaves(st.adam.mu).items()}
        self.losses = [float(x) for x in losses]
        self.params3 = {k: v.cpu() for k, v in common.leaves(st.params).items()}
        self.state, self.i = st, FIRST
        common.sync(self.dev)

    def _step(self, state, i: int):
        v = i % self.wl["views"]
        return self.T.train_step(
            state, self.pcams[v], self.gts[v:v + 1], self.bg, self.rcfg,
            self.cfg["sh_degree"], self.cfg["bsz"],
            self.cfg["optimizer"]["lambda_dssim"], self.lrs, self.sched,
            "sqrt")

    def _advance(self, state, i):
        state, m = self._step(state, i)
        i += 1
        if i == self.wl["segment"]:
            state, i = self.state0, 0
        return state, i, m

    def window(self, seconds: float) -> dict:
        st, i, steps = self.state, self.i, 0
        common.sync(self.dev)
        t0 = time.perf_counter()
        while True:
            st, i, _ = self._advance(st, i)
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        common.sync(self.dev)
        t = time.perf_counter() - t0
        self.state, self.i, self.attempted = st, i, steps
        self.note = f"{steps} steps in {t:.3f} s"
        return {"train_images_per_s": steps * self.cfg["bsz"] / t}

    def traced(self) -> dict:
        """A profiled window of the cell's ``trace_steps`` steps from the
        segment's start; the reference then counts each step's pairs, on
        the same steps run again, so that no step's input outlives it
        in the window (the step is deterministic)."""
        from .. import trace as T

        n = self.wl["trace_steps"]
        isects = []

        def run():
            st = self.state0
            for i in range(n):
                st, m = self._step(st, i)
                isects.append(m["num_isects"])

        tr = T.profile_window(run)
        self.attempted = n
        # the peak is the program's: the pair counts below are the
        # reference's work
        self.peak = common.peak_bytes(self.dev)
        walks, st = [], self.state0
        for i in range(n):
            cam = self.cams[i % self.wl["views"]]
            with torch.no_grad():
                s = R.project(common.leaves(st.params), self.alive, cam,
                              self.h, self.w, self.cfg["sh_degree"])
                lists = R.tile_lists(s, self.h, self.w, self.cfg["tile_w"],
                                     self.cfg["tile_h"])
                _, wk = R.render(s, lists, self.h, self.w, self.cfg["tile_w"],
                                 self.cfg["tile_h"], self.cfg["max_per_tile"],
                                 self.bg)
            del s, lists
            walks.append([wk])
            st, _ = self._step(st, i)
        return self._evidence(tr, walks,
                              [int(x.reshape(-1)[0]) for x in isects])

    def _evidence(self, tr, walks, isects):
        cfg = self.cfg
        pixels = self.h * self.w
        n_splats = cfg["capacity"] * cfg["bsz"]
        fwd = bwd = 0.0
        ops = 0.0
        for step in walks:
            wk = sum(w.walked for w in step)
            bl = sum(w.blended for w in step)
            en = sum(w.entries for w in step)
            fwd += counts.bound_s(*counts.blend_fwd_cost(
                wk, en, pixels * len(step), n_splats))
            bwd += counts.bound_s(*counts.blend_bwd_cost(
                wk, bl, en, pixels * len(step), n_splats))
            ops += counts.train_step_ops(wk, bl, pixels * len(step), len(step),
                                         cfg["n_live"], cfg["sh_degree"],
                                         cfg["sh_degree"])
        return common.evidence(
            tr, "train", len(walks), images=len(walks) * cfg["bsz"],
            blend_fwd_bound_s=fwd, blend_bwd_bound_s=bwd, ops=ops,
            entries_per_view=sum(isects) / len(isects) / cfg["bsz"])

    def peak_bytes(self) -> int:
        return getattr(self, "peak", None) or common.peak_bytes(self.dev)

    # -- the reference ----------------------------------------------------

    def finish(self) -> dict:
        """Free the program's state, then follow the first steps with the
        reference and compare."""
        self.state = self.state0 = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = self.reference(torch.float32)
        return train_numbers(self.losses, self.grads1, self.params3, ref,
                             {k: v.cpu() for k, v in self.params0.items()})

    def reference(self, dtype):
        cfg = self.cfg
        batches = [([self.cams[i % self.wl["views"]]],
                    [self.gts[i % self.wl["views"]]]) for i in range(FIRST)]
        return run_steps(self.params0, self.alive, batches, self.bg,
                         common.spec(cfg, self.h, self.w),
                         common.optim(cfg, cfg["spatial_lr_scale"]), 0,
                         lambda it: cfg["sh_degree"], dtype)


def readings(cfg: dict, wl: dict, seed: int, device, control: bool) -> dict:
    """The compared numbers of one seed without a window: the program's,
    or with ``control`` those of the reference in bfloat16 in its place."""
    if not control:
        return Cell(cfg, wl, seed, device).finish()
    c = Cell(cfg, wl, seed, device, program=False)
    low = c.reference(torch.bfloat16)
    p3 = {k: v.float().cpu() for k, v in low.params.items()}
    g1 = {k: v.float().cpu() for k, v in low.grads1.items()}
    ref = c.reference(torch.float32)
    return train_numbers(low.losses, g1, p3, ref,
                         {k: v.cpu() for k, v in c.params0.items()})
