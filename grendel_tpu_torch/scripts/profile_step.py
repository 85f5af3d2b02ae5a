#!/usr/bin/env python
"""Per-stage time of the training step: the port's counterpart of
scripts/profile_step.py.

    python -m grendel_tpu_torch.scripts.profile_step [--height 840 --width 1296 \\
        --n 200000 --bsz 1 --steps 20] [--trace DIR] [--device cpu]

Each stage of the training step runs and is timed alone, beside the whole
step, on random Gaussians (testing.random_gaussians) and random ground
truth, under the JAX tool's stage keys: ``full_step`` (engine/train.py
``train_step``), ``project_fwd``, ``isect`` (the tile lists, kernel K3 on
the card), ``raster_fwd`` (the blend, K1), ``raster_fwd_bwd`` (K1 and its
backward, K2 and K2s), ``loss_fwd_bwd``, ``adam`` and ``render_batch_fwd``. The
per-camera stages (isect, raster_*) run on camera 0's lists and count
``bsz`` times. The entry capacity is sized as the trainer sizes it (1.15x
camera 0's count, mantissa-rounded), and the blend budget from the
post-cull count unless ``--no_compaction``.

On the card each time is CUDA events around ``--steps`` calls after two
warm-ups, ``torch.cuda.synchronize`` ending each; on the CPU the host
clock. A stage sum above the step is normal (the step shares work across
the stages). Prints a table, the kernel launches per call of each stage,
and as its last line ``{"profile": {stage: ms}}``; ``main`` returns the
times, the launches and the stage callables ``full_step`` and ``isect``
(to run one again). ``--trace DIR`` writes a ``torch.profiler`` trace of
one step to ``DIR/trace_rk0.json`` (``utils/timer.py Tracer``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Per-stage step time")
    ap.add_argument("--height", type=int, default=840)
    ap.add_argument("--width", type=int, default=1296)
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--bsz", type=int, default=1)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--sh_degree", type=int, default=3)
    ap.add_argument("--tile", type=str, default="32x16",
                    help="WxH tile geometry")
    ap.add_argument("--trace", type=str, default=None,
                    help="torch.profiler trace directory")
    ap.add_argument("--no_compaction", action="store_true",
                    help="blend every listed entry (no post-cull budget)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    a = ap.parse_args(argv)

    from ..cameras import batch_camera_arrays
    from ..convert import params_from_numpy
    from ..device import resolve_device
    from ..engine.loss import batch_loss
    from ..engine.render import RenderConfig, render_batch
    from ..engine.train import XyzLrSchedule, train_state_init, train_step
    from ..models.gaussian_model import GaussianParams
    from ..models.optimizer import adam_step, scaled_lrs
    from ..ops.isect import compact_entries_flat, isect_tiles
    from ..ops.projection import ProjectedSplats, project_params
    from ..ops.rasterize_cuda import (rasterize_slots_fwd, rasterize_slots_vjp,
                                      segment_sum)
    from ..ops.scan_cuda import cumsum_i32_multi
    from ..testing import make_test_camera, params_fields, random_gaussians
    from ..utils.hbm import mantissa_round_cap
    from ..utils.timer import Tracer

    dev = resolve_device(a.device)
    on_card = dev.type == "cuda"
    kernels_of = {"K1": rasterize_slots_fwd, "K2": rasterize_slots_vjp,
                  "K2s": segment_sum, "K3": cumsum_i32_multi}
    h, w, n_live, bsz, sh_degree = a.height, a.width, a.n, a.bsz, a.sh_degree
    capacity = 1 << int(np.ceil(np.log2(max(n_live, 2) * 1.3)))
    g = random_gaussians(a.seed, n_live, extent=3.0, sh_degree=sh_degree,
                         scale_range=(-5.5, -3.5))
    params, alive = params_from_numpy(*params_fields(*g, capacity), dev)
    cams = batch_camera_arrays(
        [make_test_camera(w, h, dist=5.0, angle=0.1 * i) for i in range(bsz)],
        dev)
    tile_w, tile_h = (int(x) for x in a.tile.split("x"))
    tiles_x, tiles_y = -(-w // tile_w), -(-h // tile_h)
    def project():
        return project_params(params, alive, cams, h, w, sh_degree)

    with torch.no_grad():
        splats_b = project()
    splats0 = ProjectedSplats(*(x[0] for x in splats_b))

    def isect(cap):
        return isect_tiles(splats0.means2d, splats0.radii, splats0.depths,
                           tile_w, tile_h, tiles_x, tiles_y, capacity=cap,
                           opacities=splats0.opacities)

    # the entry capacity as the trainer's tuner sizes it, from camera 0's
    # exact lists
    probe = isect(0)
    n_isect, n_kept = int(probe.num_isects), int(probe.num_kept)
    isect_cap = mantissa_round_cap(1.15 * n_isect)
    blend_cap = (isect_cap if a.no_compaction
                 else min(mantissa_round_cap(1.15 * n_kept), isect_cap))
    print(f"# {n_isect} isects/cam ({n_kept} post-cull), capacity "
          f"{isect_cap}, blend {blend_cap}")
    cfg = RenderConfig(img_h=h, img_w=w, tile_w=tile_w, tile_h=tile_h,
                       isect_capacity=isect_cap, blend_capacity=blend_cap,
                       max_per_tile=1024 * (tile_w * tile_h) // 256, chunk=64)
    gt_u8 = torch.as_tensor(np.random.default_rng(a.seed).integers(
        0, 255, (bsz, 3, h, w), dtype=np.uint8), device=dev)
    gt = gt_u8.to(torch.float32) / 255.0
    bg = torch.zeros(3, device=dev)
    lrs, s = scaled_lrs(0.0025, 0.05, 0.005, 0.001, bsz=bsz)
    sched = XyzLrSchedule(1.6e-4 * s, 1.6e-6 * s, 0.01, 30000)
    state = train_state_init(params, alive)
    times, launches = {}, {}

    def timeit(key, fn, per_cam=False, warmup=2):
        """ms of one call of ``fn`` (times bsz for a per-camera stage),
        and the kernels' launches per call."""
        for _ in range(warmup):
            fn()
        for wrapper in kernels_of.values():
            wrapper.launches = 0
        if on_card:
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(a.steps):
                fn()
            end.record()
            torch.cuda.synchronize(dev)
            ms = start.elapsed_time(end) / a.steps
        else:
            t0 = time.perf_counter()
            for _ in range(a.steps):
                fn()
            ms = (time.perf_counter() - t0) / a.steps * 1e3
        times[key] = ms * (bsz if per_cam else 1)
        launches[key] = {k: wr.launches / a.steps
                         for k, wr in kernels_of.items()}

    def full():
        return train_step(state, cams, gt_u8, bg, cfg, sh_degree, bsz,
                          lambda_dssim=0.2, lrs=lrs, xyz_sched=sched)

    timeit("full_step", full)
    with torch.no_grad():
        timeit("project_fwd", project)
        timeit("isect", lambda: isect(cfg.isect_capacity), per_cam=True)
    lists = isect(cfg.isect_capacity)
    ids, toff = lists.gauss_ids, lists.tile_offsets
    if cfg.blend_cap < cfg.isect_capacity:
        ids, toff = compact_entries_flat(ids, toff, cfg.blend_cap)
    t_ids = torch.arange(cfg.num_tiles, dtype=torch.int32, device=dev)
    px0, py0 = (t_ids % tiles_x) * tile_w, (t_ids // tiles_x) * tile_h
    blend_in = [splats0.means2d, splats0.conics, splats0.colors,
                splats0.opacities]

    def raster(*inputs):
        return rasterize_slots_fwd(*inputs, ids, toff, px0, py0, tile_w,
                                   tile_h, cfg.max_per_tile)

    with torch.no_grad():
        timeit("raster_fwd", lambda: raster(*blend_in), per_cam=True)

    def raster_fwd_bwd():
        leaves = [x.detach().requires_grad_(True) for x in blend_in]
        img, t_final = raster(*leaves)
        return torch.autograd.grad(img.sum() + t_final.sum(), leaves)

    timeit("raster_fwd_bwd", raster_fwd_bwd, per_cam=True)
    img_b = torch.zeros((bsz, 3, h, w), device=dev, requires_grad=True)
    timeit("loss_fwd_bwd", lambda: torch.autograd.grad(
        batch_loss(img_b, gt, 0.2)[0], [img_b]))
    zero = GaussianParams(*(torch.zeros_like(p) for p in params))
    xyz_lr = torch.tensor(1e-4, device=dev)
    timeit("adam", lambda: adam_step(params, zero, state.adam, lrs, xyz_lr,
                                     alive))
    with torch.no_grad():
        timeit("render_batch_fwd", lambda: render_batch(
            params, alive, cams, sh_degree, cfg, bg=bg))

    if a.trace:
        tracer = Tracer(a.trace, 0, dev, None, 0)
        tracer.begin()
        full()
        tracer.stop()
        print(f"trace written to {tracer.path}")

    known = (times["project_fwd"] + times["isect"] + times["raster_fwd_bwd"]
             + times["loss_fwd_bwd"] + times["adam"])
    print(f"\n== per-stage times (ms), device={dev}, {n_live} live / cap "
          f"{capacity}, {w}x{h}, bsz={bsz}, tile {tile_w}x{tile_h} ==")
    for k, v in sorted(times.items(), key=lambda kv: -kv[1]):
        print(f"  {k:24s} {v:9.2f}")
    print(f"  {'stage_sum(indep)':24s} {known:9.2f}")
    print(f"  {'residual(step-sum)':24s} {times['full_step'] - known:9.2f}")
    print(f"# kernel launches per call: {json.dumps(launches)}")
    print(json.dumps({"profile": {k: round(v, 2) for k, v in times.items()}}))
    return {"times": times, "launches": launches, "stage_sum": known,
            "stages": {"full_step": full,
                       "isect": lambda: isect(cfg.isect_capacity)}}


if __name__ == "__main__":
    main()
