"""Entry ``render_batch``: the program's renderer
(``grendel_tpu_torch.engine.render.render_batch``) under ``no_grad``, as a
viewer drives it.

Traffic (the cell's file): one viewer in a closed loop, bsz 1, cycling
``poses`` orbit poses at ``distance``: the ring's phase and the order of
its poses drawn from the seed. Each frame is timed from its call to its
``synchronize()`` on the host clock. A sample of ``sampled`` poses, drawn
from the seed, keeps its first frame of the window with the splats' radii
and the tiles' entry counts; the reference renders those poses once the
window has closed.
"""

from __future__ import annotations

import time

import torch

from .. import counts, harness, scene
from ..reference import render as R
from ..reference.compare import frame_numbers
from . import common


class Cell:
    def __init__(self, cfg: dict, wl: dict, seed: int, device,
                 program: bool = True):
        self.cfg, self.wl, self.dev = cfg, wl, device
        common.build_kernels(device)
        gen = common.generator(seed, device)
        self.h, self.w = cfg["height"], cfg["width"]
        self.params, self.alive = scene.garden_gaussians(
            cfg["n_live"], cfg["capacity"], cfg["extent"],
            tuple(cfg["log_scale"]), tuple(cfg["opacity"]), cfg["sh_degree"],
            gen)
        self.hosts = [scene.orbit_camera(self.w, self.h, wl["distance"], a)
                      for a in scene.orbit_angles(wl["poses"], gen)]
        self.cams = [scene.device_camera(c, device) for c in self.hosts]
        self.sample = sorted(torch.randperm(
            wl["poses"], generator=gen, device=device)[:wl["sampled"]]
            .tolist())
        self.bg = torch.zeros(3, device=device)
        cap = max(common.entry_count(self.params, self.alive, c, self.h,
                                     self.w, cfg["tile_w"], cfg["tile_h"],
                                     cfg["sh_degree"]) for c in self.cams)
        self.isect_cap = common.mantissa_cap(1.15 * cap)
        self.kept = {}
        self.attempted = 0
        if program:
            self._program()

    def _program(self):
        from grendel_tpu_torch.engine import render as engine
        from grendel_tpu_torch.models.gaussian_model import GaussianParams

        cfg = self.cfg
        self.engine = engine
        self.rcfg = engine.RenderConfig(
            img_h=self.h, img_w=self.w, tile_w=cfg["tile_w"],
            tile_h=cfg["tile_h"], isect_capacity=self.isect_cap,
            max_per_tile=cfg["max_per_tile"])
        self.pparams = GaussianParams(**{k: v.clone() for k, v in
                                         self.params.items()})
        self.pcams = [common.program_camera(c, self.dev) for c in self.hosts]
        for k in range(self.wl["warmup"]):
            self._frame(k)
        common.sync(self.dev)

    def _frame(self, k: int):
        with torch.no_grad():
            return self.engine.render_batch(
                self.pparams, self.alive, self.pcams[k % len(self.pcams)],
                self.cfg["sh_degree"], self.rcfg, bg=self.bg)

    def _keep(self, k: int, out) -> None:
        """The first frame of a sampled pose, with its splats' radii and
        its tiles' entry counts, for the reference."""
        pose = k % len(self.pcams)
        if pose in self.sample and pose not in self.kept:
            img, splats, aux = out
            self.kept[pose] = (img[0].clone(), aux.n_entries[0].clone(),
                               splats.radii[0].clone())

    def window(self, seconds: float) -> dict:
        lat, k = [], 0
        common.sync(self.dev)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            out = self._frame(k)
            common.sync(self.dev)
            lat.append(time.perf_counter() - t)
            self._keep(k, out)
            k += 1
        self.attempted = k
        self.note = (f"{k} frames, ms median "
                     f"{1e3 * harness.percentile(lat, 50):.3f} p95 "
                     f"{1e3 * harness.percentile(lat, 95):.3f} max "
                     f"{1e3 * max(lat):.3f}")
        return {"render_ms_p95": 1e3 * harness.percentile(lat, 95)}

    def traced(self) -> dict:
        from .. import trace as T

        n = self.wl["trace_frames"]

        def run():
            for k in range(n):
                out = self._frame(k)
                common.sync(self.dev)
                self._keep(k, out)

        tr = T.profile_window(run)
        self.attempted = n
        # the peak is the program's: the pair counts below are the
        # reference's work
        self.peak = common.peak_bytes(self.dev)
        pixels = self.h * self.w
        fwd = ops = 0.0
        for k in range(n):
            with torch.no_grad():
                s = R.project(self.params, self.alive,
                              self.cams[k % len(self.cams)], self.h, self.w,
                              self.cfg["sh_degree"])
                lists = R.tile_lists(s, self.h, self.w, self.cfg["tile_w"],
                                     self.cfg["tile_h"])
                _, wk = R.render(s, lists, self.h, self.w, self.cfg["tile_w"],
                                 self.cfg["tile_h"], self.cfg["max_per_tile"],
                                 self.bg)
            fwd += counts.bound_s(*counts.blend_fwd_cost(
                wk.walked, wk.entries, pixels, self.cfg["capacity"]))
            ops += counts.render_ops(wk.walked, self.cfg["n_live"],
                                     self.cfg["sh_degree"])
        return common.evidence(tr, "render", n, blend_fwd_bound_s=fwd,
                               ops=ops)

    def peak_bytes(self) -> int:
        return getattr(self, "peak", None) or common.peak_bytes(self.dev)

    def finish(self) -> dict:
        """The reference's frames of the sampled poses against those the
        window kept. A sampled pose the window never rendered fails."""
        self.pparams = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        if set(self.kept) != set(self.sample):
            return {"frame_max_err": float("inf")}
        ref = [self.reference(p, torch.float32) for p in self.sample]
        got = [self.kept[p] for p in self.sample]
        return frame_numbers([g[0] for g in got], [r[0] for r in ref],
                             [g[1] for g in got], [r[1] for r in ref],
                             [g[2] for g in got], [r[2] for r in ref])

    def reference(self, pose: int, dtype):
        """(frame, entries of each tile, radii) of one pose."""
        cfg = self.cfg
        with torch.no_grad():
            s = R.project(self.params, self.alive, self.cams[pose], self.h,
                          self.w, cfg["sh_degree"], dtype)
            lists = R.tile_lists(s, self.h, self.w, cfg["tile_w"],
                                 cfg["tile_h"])
            img, _ = R.render(s, lists, self.h, self.w, cfg["tile_w"],
                              cfg["tile_h"], cfg["max_per_tile"], self.bg,
                              dtype)
        return img.float(), lists.counts, s.radius


def readings(cfg: dict, wl: dict, seed: int, device, control: bool) -> dict:
    """The compared numbers of one seed after a window of ``calibrate_s``
    seconds: the program's, or with ``control`` those of the reference in
    bfloat16 in its place."""
    if not control:
        c = Cell(cfg, wl, seed, device)
        c.window(wl["calibrate_s"])
        return c.finish()
    c = Cell(cfg, wl, seed, device, program=False)
    low = [c.reference(p, torch.bfloat16) for p in c.sample]
    ref = [c.reference(p, torch.float32) for p in c.sample]
    return frame_numbers(*([x[i] for x in side] for i in range(3)
                           for side in (low, ref)))
