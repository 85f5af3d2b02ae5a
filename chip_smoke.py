#!/usr/bin/env python3
"""Chip smoke run of grendel_tpu_torch, the PyTorch + CUDA port, on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which fails the run:

  1. print the card (nvidia-smi name and power limit) and the versions;
  2. build the port's CUDA kernels from csrc/ (one nvcc per source, in
     parallel) and print the build time and the compiler's register report;
  3. scan kernel K3 bit-equal to torch.cumsum (its plain version): at
     lengths 0, 1 and around one and three tiles for 1, 4 and 8
     channels, at the main path's shapes and at odd lengths, over 1,000
     back-to-back calls on one scratch, and across the wrap of the
     scratch's epoch;
  4. blend kernel K1 against its plain version on the main path's real
     tile lists: max abs error <= 1e-5 on colors and on final_t; backward
     blend kernel K2 against its plain version on the same lists with
     random cotangents: every output finite, and max |K2 - plain| <=
     1e-4 max |plain| for each (the slack covers the order of the float
     atomics); both again on a saturating scene (opacity 0.999, 16x16
     tiles) and on a small scene at 32x8, 64x4 and 128x2 tiles, where
     both walk 2 or 1 pixels a thread on other warp patches; K1 alone on
     12x10 tiles (120 pixels, not a multiple of 32, which K2 refuses),
     where it walks one pixel a thread without the patch reject;
  5. the render path at full width: the garden-scale model (200,000 live
     Gaussians in a capacity of 262,144, SH 3) saved to PLY, loaded on the
     card and rendered by render_batch for 2 cameras at 1296x840 with
     32x16 tiles; launch counters must show K1 and K3 ran, the images
     must be finite and sane, and a small scene rendered on the card must
     agree with the plain CPU reference;
  6. the training path at full width, the main path: 10 train_steps of
     testing.garden_training (the step bench.py times: bsz 2, random
     ground truth, the default optimizer); the launch counters must show
     K1, K2 and K3 in every step, every loss and parameter must be
     finite, the 10th loss below the 1st, and the state at iteration 20
     with Adam count 10; one train_step on the small flagship scene on the
     card must agree with the same step on the CPU (plain versions):
     loss to 1e-5 relative, Adam moments to atol 1e-4, rtol 1e-3;
  7. the host training loop at full width, this slice's main path:
     Trainer on the raytraced StructuredSyntheticScene (1280x832, 8 train
     and 2 held-out views, 100,000 initial points), bsz 2 for 300
     iterations with densify rounds at 200 and 300, an opacity reset at
     200 and a checkpoint at 200; the launch counters must show K1, K2
     and K3 in every step, and the run must densify with clones or splits
     at least twice, grow the capacity, reset the opacity, keep every
     parameter finite, raise the held-out PSNR, and resume from its
     iteration-200 checkpoint for two more steps; K1, K2 and K3 are held
     against their plain versions, at phases 3-4's tolerances, on the
     inputs the loop's last step gave them (K2 on the loss's own
     cotangents);
  8. the DMA microbenchmark's kernels: K4 and K5 bit-equal to their plain
     versions at an odd chunk count (row widths 16 and 128, 0 and 24
     arithmetic rounds; ids -1 and past the table among K5's, which
     gather rows of zeros); then the microbenchmark itself at both row
     widths, which checks its own default sizes the same way before it
     times them, and whose launch counters must show K4 and K5;
  9. timings: render_batch and train_step (host clock, median of 20 after
     2 warm-ups, taken between phases 6 and 7; the step again after phase
     8), a profiler breakdown of each with the step's device time, and
     each kernel, its plain version and the library call (CUDA events,
     with the L2 cache flushed before each launch), beside the least time
     the card could take; each kernel also on the device's clock alone
     (``device_ms``: the host's time to reach the launch hidden); K1 and
     K2 also on the loop step's inputs, K3 per shape with its wrapper's
     host time per call.

``--save-k2 DIR`` also saves K2's inputs on the garden and on the loop's
last step for grendel_tpu_torch/scripts/time_kernels.py. Prints one
``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
no CUDA device is available or the package is not beside this file.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM at 700 W (NVIDIA H100 datasheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# K1 work per (entry, pixel) pair: one exp and about 15 f32 operations
K1_OPS_PER_PAIR = 16
# K2 rebuilds K1's alpha and T for every pair it walks (the same 16), and
# for every pair the forward blended adds about 35 f32 operations of
# gradient arithmetic and 9 adds that sum the pair into its entry
K2_OPS_PER_BLENDED = 44
TILE_W, TILE_H, MAX_PER_TILE, BSZ = 32, 16, 2048, 2
K1_TOL = 1e-5
K2_REL_TOL = 1e-4
# one small train_step, card vs CPU: each Adam moment leaf within this
# much of its largest value (the rtol of the whole-step gradient bound)
MOMENT_REL_TOL = 1e-3
TRAIN_STEPS = 10
# the host training loop: the structured scene and its schedule
LOOP_SCENE = dict(width=1280, height=832, n_cams=10, llffhold=5,
                  n_init_points=100_000, seed=0)
LOOP_ITERS, LOOP_CHECKPOINT, LOOP_RESUME_STEPS = 300, 200, 2
# the DMA microbenchmark: scripts/microbench_dma.py's defaults, and an odd
# chunk count for the checks
DMA_N, DMA_CAP, DMA_VPU_ITERS, DMA_ODD_CHUNKS = 262_144, 1_048_576, 24, 1001


def require(ok, what):
    if not ok:
        raise RuntimeError(f"chip smoke failed: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Median time of one call (``kernels.cold_ms``): CUDA events around
    each launch, with the L2 cache flushed before every launch (the 50 MB
    L2 would otherwise hold a previous launch's inputs). ``ms`` also counts
    any time the card waits for the host to reach the launch, as a step
    that the host holds back does; ``device_ms`` hides it behind a spin on
    the card and reads the device's time alone."""

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps):
        from grendel_tpu_torch.kernels import cold_ms

        return cold_ms(fn, reps, self.flush)

    def device_ms(self, fn, reps):
        from grendel_tpu_torch.kernels import cold_ms

        return cold_ms(fn, reps, self.flush, spin=True)


def host_us(fn, calls=200):
    """Host microseconds per call of ``fn`` over ``calls`` calls back to
    back with no synchronize between them: the time the host takes to
    enqueue one call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def walked_pairs(m2d, con, op, ids, lo, hi, px0, py0, tile_w=TILE_W,
                 tile_h=TILE_H, max_per_tile=MAX_PER_TILE, chunk=64):
    """(entry, pixel) pairs the front-to-back walk must evaluate: per
    pixel, the entries of its slot's span up to and including the one that
    stops it (or the whole span); and, of those, the pairs it blends."""
    from grendel_tpu_torch.ops.blend import T_EPS, splat_alpha
    from grendel_tpu_torch.ops.rasterize_torch import slot_pixels

    lo, hi = lo.long(), hi.long()
    hi_eff = torch.minimum(hi, lo + max_per_tile)
    px, py = slot_pixels(px0, py0, tile_w, tile_h)
    t = torch.ones_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    pairs = torch.zeros((), dtype=torch.int64, device=px.device)
    blended = torch.zeros((), dtype=torch.int64, device=px.device)
    steps = torch.arange(chunk, device=px.device)
    cap, m = ids.shape[0], m2d.shape[0]
    for c0 in range(0, int((hi_eff - lo).max()), chunk):
        k = lo[:, None] + c0 + steps
        valid = k < hi_eff[:, None]
        g = ids[k.clamp(0, cap - 1)].long()
        valid = valid & (g >= 0) & (g < m)
        g = torch.where(valid, g, torch.zeros_like(g))
        xy = m2d[g]
        o = torch.where(valid, op[g], torch.zeros_like(xy[..., 0]))
        alphas = splat_alpha(px[:, None, :] - xy[..., 0:1],
                             py[:, None, :] - xy[..., 1:2], con[g], o)
        for j in range(chunk):
            live = valid[:, j, None] & ~done
            pairs += live.sum()
            t_after = t * (1.0 - alphas[:, j])
            stop = live & (t_after < T_EPS)
            blended += (live & ~stop & (alphas[:, j] > 0)).sum()
            t = torch.where(live & ~stop, t_after, t)
            done = done | stop
    return int(pairs), int(blended)


def profile(fn, calls, top=14):
    """Device time by kernel over ``calls`` calls of ``fn`` under
    torch.profiler, per call, and the share of the window's wall time the
    device was busy (the profiler's own overhead lengthens the window).
    Returns the device ms per call and the rows (ms, launches, name) per
    call."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            rows.append((us / 1e3 / calls, e.count / calls, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"# profile of {calls} calls: device busy {busy_ms:.3f} ms of "
          f"{wall_ms / calls:.3f} ms wall per call ({busy_ms * calls / wall_ms:.1%}"
          f"), {sum(r[1] for r in rows):.0f} kernel launches per call")
    for ms, n, key in rows[:top]:
        print(f"#   {ms:8.4f} ms  {n:5.1f}x  {key[:90]}")
    return busy_ms, rows


def host_walls(fn, calls):
    """Host-clock ms of ``calls`` calls, each ending in a synchronize,
    after 2 warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def stamp(t_start, what):
    print(f"# [{time.perf_counter() - t_start:6.1f} s] {what}")


def rel_err(got, want):
    """max |got - want| / max |want| over one output."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def k1_check(what, blend_in, blend_kw):
    """K1 against its plain version on one set of tile lists, within K1_TOL
    on colors and final_t. Returns K1's outputs and its max abs error."""
    from grendel_tpu_torch.ops.rasterize_cuda import rasterize_slots_fwd
    from grendel_tpu_torch.ops.rasterize_torch import rasterize_slots

    col_k, t_k = rasterize_slots_fwd(*blend_in, **blend_kw)
    col_p, t_p = rasterize_slots(*blend_in, **blend_kw)
    torch.cuda.synchronize()
    k1_err = max(float((col_k - col_p).abs().max()),
                 float((t_k - t_p).abs().max()))
    require(bool(torch.isfinite(col_k).all() and torch.isfinite(t_k).all()),
            f"K1 output not finite ({what})")
    print(f"# K1 blend ({what}): max abs err vs plain {k1_err:.3e} over "
          f"{t_k.shape[0]} slots x {t_k.shape[1]} px (tol {K1_TOL})")
    require(k1_err <= K1_TOL,
            f"K1 differs from its plain version ({what}): {k1_err}")
    return col_k, t_k, k1_err


def blend_check(what, blend_in, blend_kw, g, g_t):
    """K1 and K2 against their plain versions on one set of tile lists: K1
    within K1_TOL on colors and final_t; K2 on the cotangents ``g`` and
    ``g_t`` finite and within K2_REL_TOL of each output's largest value.
    Returns K1's outputs, K2's keyword arguments and each kernel's max abs
    error."""
    from grendel_tpu_torch.ops.rasterize_cuda import rasterize_slots_vjp
    from grendel_tpu_torch.ops.rasterize_torch import rasterize_slots_bwd

    col_k, t_k, k1_err = k1_check(what, blend_in, blend_kw)
    bwd_kw = dict(blend_kw, c_total=col_k, final_t=t_k, g=g, g_t=g_t)
    d_k = rasterize_slots_vjp(*blend_in, **bwd_kw)
    d_p = rasterize_slots_bwd(*blend_in, **bwd_kw)
    torch.cuda.synchronize()
    names = ("d_means2d", "d_conics", "d_colors", "d_opacities")
    require(all(bool(torch.isfinite(x).all()) for x in d_k),
            f"K2 output not finite ({what})")
    k2_rel = {n: rel_err(a, b) for n, a, b in zip(names, d_k, d_p)}
    k2_err = max(float((a - b).abs().max()) for a, b in zip(d_k, d_p))
    print(f"# K2 backward blend ({what}): max |K2 - plain| / max |plain| "
          f"{ {n: f'{e:.3e}' for n, e in k2_rel.items()} }, max abs err "
          f"{k2_err:.3e} (tol {K2_REL_TOL} relative)")
    require(max(k2_rel.values()) <= K2_REL_TOL,
            f"K2 differs from its plain version ({what}): {k2_rel}")
    return col_k, t_k, bwd_kw, k1_err, k2_err


def scan_check(what, calls):
    """K3 bit-equal to its plain version on each list of int32 channels in
    ``calls``; returns the max abs error (0)."""
    from grendel_tpu_torch.ops import scan_cuda

    err = 0
    for xs in calls:
        got = scan_cuda.cumsum_i32_multi(xs)
        want = scan_cuda.cumsum_i32_multi_plain(xs)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            require(g.dtype == torch.int32 and torch.equal(g, w),
                    f"K3 differs from its plain version ({what}) at "
                    f"C={len(xs)} M={xs[0].shape[0]}")
            if g.numel():
                err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def scan_stress(dev, gen, main_shapes):
    """Phase 3: K3 bit-equal to torch.cumsum at the edges of its tile, at
    the main path's shapes and at odd lengths, over 1,000 back-to-back
    calls on one scratch and across the wrap of the scratch's epoch.
    Returns the max abs error
    (0) and the number of calls checked."""
    from grendel_tpu_torch.ops import scan_cuda

    tile = scan_cuda.tile_elems()
    shapes = [(c, m) for m in (0, 1, tile - 1, tile, tile + 1, 3 * tile + 17)
              for c in (1, 4, 8)] + list(main_shapes) + [
        (1, 1_200_000), (4, 1_200_000), (4, 524_288), (3, 4097),
        (2, 99_999), (8, 12_305)]                      # odd lengths

    def chans(c, m):
        return [torch.randint(-5000, 5000, (m,), generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(c)]

    err = scan_check("tile edges and the main path's shapes",
                     [chans(c, m) for c, m in shapes])
    n = len(shapes)
    # 1,000 calls back to back on one scratch, checked after the last
    scratch = scan_cuda.scan_scratch(dev)
    inputs = [chans(c, m) for c, m in ((1, 3 * tile + 17), (4, 2 * tile),
                                       (2, 100_000))]
    words = scratch.words
    outs = [scan_cuda.cumsum_i32_multi(inputs[i % 3]) for i in range(1000)]
    require(scratch.words is words, "the scan scratch was reallocated")
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        for g, x in zip(got, inputs[i % 3]):
            require(torch.equal(g, torch.cumsum(x, 0, dtype=torch.int32)),
                    f"K3 back-to-back call {i} differs from torch.cumsum")
    n += len(outs)
    # across the epoch's wrap: the last epoch, then 1 and 2 again
    scratch.epoch = scan_cuda.EPOCH_MAX - 1
    epochs = []
    for _ in range(3):
        err = max(err, scan_check("across the epoch's wrap", [inputs[0]]))
        epochs.append(scratch.epoch)
    require(epochs == [scan_cuda.EPOCH_MAX, 1, 2],
            f"epochs across the wrap: {epochs}")
    return err, n + 3


def small_blend_inputs(dev, tile_w=16, tile_h=16, w=64, h=48,
                       opacity=0.999):
    """A small scene's blend inputs through the port: 1,200 Gaussians of
    seed 11 projected at ``w`` x ``h``, flat tile lists of ``tile_w`` x
    ``tile_h``. By default the saturating scene, built as
    tests/test_torch_blend_bwd.py builds its saturated one (64x48, every
    opacity set to 0.999, 16x16 tiles); ``opacity=None`` keeps the
    Gaussians' own."""
    from grendel_tpu_torch.cameras import camera_arrays
    from grendel_tpu_torch.ops.isect import isect_tiles
    from grendel_tpu_torch.ops.projection import project_gaussians
    from grendel_tpu_torch.testing import make_test_camera, random_gaussians

    tx, ty = -(-w // tile_w), -(-h // tile_h)
    g = [torch.from_numpy(x).to(dev)
         for x in random_gaussians(11, 1200, sh_degree=3)]
    ca = camera_arrays(make_test_camera(width=w, height=h), dev)
    s = project_gaussians(*g, torch.ones(1200, dtype=torch.bool, device=dev),
                          ca.viewmat, ca.full_proj, ca.campos, ca.tanfov, h,
                          w, 3)
    isect = isect_tiles(s.means2d, s.radii, s.depths, tile_w, tile_h, tx, ty,
                        1 << 17)
    t_ids = torch.arange(tx * ty, dtype=torch.int32, device=dev)
    op = s.opacities if opacity is None else torch.full_like(s.opacities,
                                                             opacity)
    return ((s.means2d, s.conics, s.colors, op, isect.gauss_ids,
             isect.tile_offsets, (t_ids % tx) * tile_w, (t_ids // tx) * tile_h,
             tile_w, tile_h, 1024), {})


def train_phase(kernels_of, tr, steps):
    """Run ``steps`` train_steps from ``tr.state``, zeroing every launch
    counter just before each step and reading it just after. Returns the
    final state, the losses and the launches summed over the steps."""
    state, losses = tr.state, []
    totals = {name: 0 for name in kernels_of}
    for i in range(steps):
        for wrapper in kernels_of.values():
            wrapper.launches = 0
        state, m = tr.step(state)
        torch.cuda.synchronize()
        n = {name: w.launches for name, w in kernels_of.items()}
        loss = float(m["loss"])
        print(f"# train_step {i + 1}: loss {loss:.6f} l1 "
              f"{[round(float(x), 6) for x in m['l1']]} ssim "
              f"{[round(float(x), 6) for x in m['ssim']]} launches {n}")
        require(all(v > 0 for v in n.values()),
                f"step {i + 1}: a kernel of the training path did not "
                f"launch: {n}")
        require(bool(torch.isfinite(m["loss"])), f"step {i + 1}: loss {loss}")
        losses.append(loss)
        for name in totals:
            totals[name] += n[name]
    return state, losses, totals


def loop_config(model_path, iterations=LOOP_ITERS):
    """The loop's schedule: bsz 2, densify every 100 from 100 to
    ``iterations``, an opacity reset every 200, a checkpoint at 200, no
    eval, PLY save or checkpoint beyond that."""
    from grendel_tpu_torch.config import TrainConfig

    cfg = TrainConfig()
    cfg.model.model_path = model_path
    cfg.dist.bsz = BSZ
    o = cfg.opt
    o.iterations = iterations
    o.densify_from_iter, o.densification_interval = 100, 100
    o.densify_until_iter = iterations
    o.opacity_reset_interval = 200
    cfg.checkpoint_iterations = [LOOP_CHECKPOINT]
    cfg.test_iterations, cfg.save_iterations = [], []
    cfg.log_interval = 50
    return cfg.finalize()


def capture_kernel_inputs(calls):
    """Within the ``with`` block, record what the training step hands K2
    (its inputs, which are K1's, K1's outputs and the loss's cotangents)
    and K3 (its int32 channels) in ``calls["K2"]`` and ``calls["K3"]``.
    The kernels still run, and count their launches, as they would."""
    import contextlib

    from grendel_tpu_torch.ops import isect as I
    from grendel_tpu_torch.ops import rasterize_cuda

    real = (rasterize_cuda._blend_vjp, I.cumsum_i32_multi, I.cumsum_i32)

    def blend_vjp(*args):
        calls["K2"].append(tuple(a.detach() if torch.is_tensor(a) else a
                                 for a in args))
        return real[0](*args)

    def scan_multi(xs):
        calls["K3"].append([x.clone() for x in xs])
        return real[1](xs)

    def scan_one(x):
        calls["K3"].append([x.clone()])
        return real[2](x)

    @contextlib.contextmanager
    def patched():
        calls["K2"], calls["K3"] = [], []
        (rasterize_cuda._blend_vjp, I.cumsum_i32_multi,
         I.cumsum_i32) = blend_vjp, scan_multi, scan_one
        try:
            yield
        finally:
            rasterize_cuda._blend_vjp, I.cumsum_i32_multi, I.cumsum_i32 = real
    return patched()


def loop_kernel_checks(calls):
    """K1, K2 and K3 against their plain versions on the inputs one loop
    step gave them. Returns each kernel's max abs error."""
    require(len(calls["K2"]) == 1 and calls["K3"],
            f"captured {len(calls['K2'])} K2 and {len(calls['K3'])} K3 "
            f"calls in one loop step")
    (m2d, con, col, op, ids, lo, hi, px0, py0, tw, th, mpt, c_total, final_t,
     g, g_t) = calls["K2"][0]
    blend_in = (m2d, con, col, op, ids, None, px0, py0, tw, th, mpt)
    col_k, t_k, _, k1_err, k2_err = blend_check(
        "a loop step's tile lists", blend_in, dict(tile_lo=lo, tile_hi=hi),
        g, g_t)
    require(torch.equal(col_k, c_total) and torch.equal(t_k, final_t),
            "K1 run again differs from the loop step's forward")
    k3_err = scan_check("a loop step", calls["K3"])
    print(f"# K3 scan (a loop step): bit-equal to plain in "
          f"{len(calls['K3'])} calls")
    return {"K1": k1_err, "K2": k2_err, "K3": k3_err}


def loop_path(dev, tag, kernels_of, scene_kw, model_path,
              iterations=LOOP_ITERS):
    """Phase 7: the host training loop through ``Trainer``, as a user
    trains; K1-K3 held against their plain versions on the last step's
    inputs. Returns the launches summed over the run's steps, each
    kernel's max abs error on that step and K2's inputs there."""
    import dataclasses

    from grendel_tpu_torch.engine.checkpoint import find_latest_checkpoint
    from grendel_tpu_torch.engine.trainer import Trainer
    from grendel_tpu_torch.testing import StructuredSyntheticScene

    t0 = time.perf_counter()
    scene = StructuredSyntheticScene(**scene_kw)
    print(f"# structured scene: {len(scene.train_cameras)} train / "
          f"{len(scene.test_cameras)} held-out views at {scene_kw['width']}x"
          f"{scene_kw['height']}, {scene.point_cloud.points.shape[0]} initial "
          f"points, raytraced in {time.perf_counter() - t0:.1f} s")
    cfg = loop_config(model_path, iterations)
    trainer = Trainer(cfg, scene, device=dev)
    cap0 = trainer.capacity
    psnr_before = trainer.eval_psnr(scene.test_cameras, 0)

    # every step must launch every kernel: zero the counters before each
    # step, read them after it
    totals = {name: 0 for name in kernels_of}
    losses = []
    real_step = trainer._step
    calls = {}

    def step(*args, **kw):
        for wrapper in kernels_of.values():
            wrapper.launches = 0
        if len(losses) == iterations // BSZ - 1:     # the last step
            with capture_kernel_inputs(calls):
                state, metrics = real_step(*args, **kw)
        else:
            state, metrics = real_step(*args, **kw)
        n = {name: w.launches for name, w in kernels_of.items()}
        require(all(v > 0 for v in n.values()),
                f"loop step {len(losses) + 1}: a kernel did not launch: {n}")
        for name in totals:
            totals[name] += n[name]
        losses.append(metrics["loss"])
        return state, metrics

    trainer._step = step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the loop's own memory: the peak above what earlier phases hold
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = trainer.train()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    train_secs = trainer.end2end.total_seconds()
    losses = torch.stack(losses).cpu()
    psnr_after = trainer.eval_psnr(scene.test_cameras, 0)
    n_alive = int(state.alive.sum())
    print(f"# loop: {iterations} iterations ({len(losses)} steps) in "
          f"{secs:.2f} s, {train_secs:.2f} s without checkpoint saves = "
          f"{iterations / train_secs:.2f} iterations/s, peak device memory "
          f"{peak_gib:.2f} GiB above the {base / 2**30:.2f} GiB held before "
          f"it {tag}")
    print(f"# loop: launches {totals}; loss {float(losses[0]):.5f} -> "
          f"{float(losses[-1]):.5f}; capacity {cap0} -> {trainer.capacity}, "
          f"events {trainer.capacity_events}; opacity resets at "
          f"{trainer.opacity_reset_iters}; {n_alive} alive")
    for rec in trainer.densify_history:
        print(f"# loop densify: {rec}")
    print(f"# loop held-out PSNR {psnr_before['psnr']:.3f} -> "
          f"{psnr_after['psnr']:.3f} dB, L1 {psnr_before['l1']:.5f} -> "
          f"{psnr_after['l1']:.5f} ({psnr_after['n']} views)")
    require(len(losses) == iterations // BSZ
            and int(state.iteration) == iterations,
            f"loop ran {len(losses)} steps to iteration "
            f"{int(state.iteration)}")
    require(bool(torch.isfinite(losses).all()), "non-finite loop loss")
    require(all(bool(torch.isfinite(p).all()) for p in state.params),
            "non-finite parameter after the loop")
    grew = sum(r["clone"] + r["split"] > 0 for r in trainer.densify_history)
    require(grew >= 2, f"fewer than two densify rounds cloned or split: "
            f"{trainer.densify_history}")
    require(("capacity_grow" in [k for k, _ in trainer.capacity_events])
            and trainer.capacity > cap0, "the capacity never grew")
    require(bool(trainer.opacity_reset_iters), "no opacity reset fired")
    require(n_alive == trainer.densify_history[-1]["alive"],
            "alive count differs from the last densify's")
    require(psnr_after["psnr"] > psnr_before["psnr"],
            f"held-out PSNR did not rise: {psnr_before} -> {psnr_after}")
    errs = loop_kernel_checks(calls)
    step_k2_in = calls["K2"][0]
    calls.clear()

    # resume from the mid-run checkpoint and take two more steps
    ckpt = find_latest_checkpoint(model_path)
    require(ckpt is not None and ckpt.endswith(str(LOOP_CHECKPOINT)),
            f"checkpoint {ckpt}")
    cfg2 = dataclasses.replace(cfg, start_checkpoint=ckpt,
                               checkpoint_iterations=[])
    cfg2.opt = dataclasses.replace(cfg.opt, densify_from_iter=10 ** 9,
                                   densify_until_iter=0)
    resumed = Trainer(cfg2, scene, device=dev)
    require(int(resumed.state.iteration) == LOOP_CHECKPOINT,
            f"resumed at iteration {int(resumed.state.iteration)}")
    st = resumed.train(LOOP_CHECKPOINT + LOOP_RESUME_STEPS * BSZ)
    require(int(st.iteration) == LOOP_CHECKPOINT + LOOP_RESUME_STEPS * BSZ
            and all(bool(torch.isfinite(p).all()) for p in st.params),
            f"resume reached iteration {int(st.iteration)}")
    print(f"# loop resumed from {os.path.basename(ckpt)}: iteration "
          f"{LOOP_CHECKPOINT} -> {int(st.iteration)}, {int(st.alive.sum())} "
          f"alive")
    return totals, errs, step_k2_in


def dma_check(dev):
    """Phase 8, first half: K4 and K5 bit-equal to their plain versions at
    an odd chunk count, at both row widths and 0 and DMA_VPU_ITERS rounds,
    with some of K5's ids out of range (-1, the table's length and 2^31 -
    1: rows of zeros). The microbenchmark checks its own default sizes in
    phase 8's second half. Returns each kernel's max abs error."""
    from grendel_tpu_torch.ops import dma_bench as D
    from grendel_tpu_torch.scripts import microbench_dma as M

    err = {"dma_contig": 0, "dma_scattered": 0}
    for width in D.ROW_WIDTHS:
        table, ids, src = M.make_inputs(DMA_N, DMA_ODD_CHUNKS * 128, width,
                                        dev, seed=width)
        ids[::97] = -1
        ids[5::131] = table.shape[0]
        ids[7::211] = 2 ** 31 - 1
        for k, e in M.check_checksums(table, ids, src, DMA_VPU_ITERS).items():
            err[k] = max(err[k], e)
    print(f"# K4 and K5: checksums bit-equal to plain at {DMA_ODD_CHUNKS} "
          f"chunks (W 16 and 128, vpu_iters 0 and {DMA_VPU_ITERS}; "
          f"{int((ids < 0).sum() + (ids >= DMA_N).sum())} of K5's ids out "
          f"of range)")
    return err


def dma_path(dev, tag, n=DMA_N, cap=DMA_CAP, steps=20):
    """Phase 8, second half: the microbenchmark as a user runs it, at both
    row widths; it checks K4 and K5 against their plain versions before it
    times them. Returns its launches, its result lines and each kernel's
    max abs error."""
    from grendel_tpu_torch.ops import dma_bench as D
    from grendel_tpu_torch.scripts import microbench_dma as M

    D.contig_checksum.launches = D.scattered_checksum.launches = 0
    results = {}
    err = {"dma_contig": 0, "dma_scattered": 0}
    for width in D.ROW_WIDTHS:
        res = M.run(n, cap, steps, DMA_VPU_ITERS, width, dev)
        results[width] = res
        for k, e in res["checksum_max_abs_err"].items():
            err[k] = max(err[k], e)
        print(f"# microbench_dma W={width} ({res['rows']} rows, "
              f"{res['distinct_rows']} distinct, table "
              f"{n * width * 4 / 2**20:.0f} MiB): " + ", ".join(
                  f"{m} {res[m + '_ns_per_row']:.5f} ns/row" for m in M.MODES)
              + f" {tag}")
    launches = {"K4": D.contig_checksum.launches,
                "K5": D.scattered_checksum.launches}
    print(f"# microbenchmark launches: {launches}; checksums bit-equal to "
          f"plain at {cap // 128} chunks")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the microbenchmark did not launch: {launches}")
    return launches, results, err


def scattered_bytes(distinct_rows, width, rows):
    """The bytes K5 must move: each distinct table row it touches read
    once, the ids read once, one checksum per chunk written."""
    return distinct_rows * width * 4 + rows * 4 + rows // 128 * 4


def dma_rows(dev, timer, tag, results):
    """K4 and K5 timed for the kernels line at the microbenchmark's
    default shapes and its inputs (K5 at the real 64-byte row, no
    arithmetic); the microbenchmark's other K5 shapes, from its own
    ``results``, beside their bounds."""
    from grendel_tpu_torch.ops import dma_bench as D
    from grendel_tpu_torch.scripts import microbench_dma as M

    table, ids, src = M.make_inputs(DMA_N, DMA_CAP, 16, dev)
    n_chunks = src.shape[0]
    words = src.view(torch.int32).reshape(n_chunks, -1)
    k4_bytes = src.numel() * 4 + n_chunks * 4
    k4 = {"ms": timer.ms(lambda: D.contig_checksum(src), 20),
          "device_ms": timer.device_ms(lambda: D.contig_checksum(src), 20),
          "plain_ms": timer.ms(lambda: D.contig_checksum_plain(src), 5),
          "library_ms": timer.ms(lambda: words.sum(dim=1), 20),
          "bound_ms": 1e3 * k4_bytes / HBM_BYTES_PER_S}
    rows, distinct = ids.shape[0], int(ids.unique().numel())
    require(distinct == results[16]["distinct_rows"],
            "the timed K5 inputs are not the microbenchmark's")
    k5_bytes = scattered_bytes(distinct, 16, rows)
    k5 = {"ms": timer.ms(lambda: D.scattered_checksum(table, ids, 0), 20),
          "device_ms": timer.device_ms(
              lambda: D.scattered_checksum(table, ids, 0), 20),
          "plain_ms": timer.ms(
              lambda: D.scattered_checksum_plain(table, ids, 0), 5),
          "library_ms": timer.ms(lambda: table[ids].sum(), 20),
          "bound_ms": 1e3 * k5_bytes / HBM_BYTES_PER_S}
    for name, r, nbytes in (("K4", k4, k4_bytes),
                            (f"K5 W=16 rows={rows}", k5, k5_bytes)):
        print(f"# {name}, cold L2: {r['ms']:.4f} ms (device alone "
              f"{r['device_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({nbytes} bytes) {tag}")
    # every K5 shape of the microbenchmark (warm L2, back to back)
    for width, res in sorted(results.items()):
        nbytes = scattered_bytes(res["distinct_rows"], width, res["rows"])
        print(f"# K5 W={width} in the microbenchmark: vpu_iters 0 "
              f"{res['dma_scattered_ms']:.4f} ms, vpu_iters "
              f"{res['vpu_iters']} {res['dma_scattered_vpu_ms']:.4f} ms, "
              f"torch gather {res['torch_gather_ms']:.4f} ms; bound "
              f"{1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms ({nbytes} bytes: "
              f"{res['distinct_rows']} distinct rows) {tag}")
    return k4, k5


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Chip smoke run of the port.")
    ap.add_argument("--save-k2", metavar="DIR",
                    help="save K2's inputs on the garden (k2_garden.pt) and "
                    "on the loop's last step (k2_step.pt) in DIR, for "
                    "grendel_tpu_torch/scripts/time_kernels.py")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from grendel_tpu_torch import kernels
    from grendel_tpu_torch.cameras import batch_camera_arrays
    from grendel_tpu_torch.convert import params_from_numpy
    from grendel_tpu_torch.engine import render as R
    from grendel_tpu_torch.engine.gaussian_io import load_ply, save_ply
    from grendel_tpu_torch.engine.loss import batch_loss
    from grendel_tpu_torch.models.gaussian_model import GaussianParams
    from grendel_tpu_torch.models.optimizer import adam_step
    from grendel_tpu_torch.ops import rasterize_cuda, scan_cuda
    from grendel_tpu_torch.ops.rasterize_torch import (rasterize_slots,
                                                       rasterize_slots_bwd)
    from grendel_tpu_torch.testing import (flagship_inputs, flagship_training,
                                           garden_blend_inputs,
                                           garden_render_config, garden_scene,
                                           garden_training, make_test_camera,
                                           params_fields, random_gaussians)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"# card: {card}")
    print(f"# python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    tag = f"[{card}]"
    k1 = rasterize_cuda.rasterize_slots_fwd
    k2 = rasterize_cuda.rasterize_slots_vjp
    k3 = scan_cuda.cumsum_i32_multi

    # --- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    logs = kernels.build()
    print(f"# build: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(logs) or 'nothing (cached)'}")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                        "spill")):
                print(f"#   {name}: {line.strip()}")

    # --- main-path inputs ----------------------------------------------
    scene = garden_scene(seed=0, device=dev)
    cams = batch_camera_arrays(scene.cameras, dev)
    (ROOT / "output").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "output") as tmp:
        ply = os.path.join(tmp, "garden.ply")
        save_ply(ply, scene.params, scene.alive)
        params, alive = load_ply(ply, capacity=scene.alive.shape[0],
                                 device=dev)
    require(torch.equal(alive, scene.alive) and all(
        torch.equal(a, b) for a, b in zip(params, scene.params)),
        "PLY round trip changed the model")
    h, w, sh = scene.img_h, scene.img_w, scene.sh_degree
    cfg, n_isect, n_kept = garden_render_config(scene)
    require((cfg.tile_w, cfg.tile_h, cfg.max_per_tile)
            == (TILE_W, TILE_H, MAX_PER_TILE), "garden tile geometry")
    tiles_x, tiles_y = cfg.tiles_x, cfg.tiles_y
    isect_cap, blend_cap = cfg.isect_capacity, cfg.blend_cap
    print(f"# garden: {int(alive.sum())} live / {alive.shape[0]}, {w}x{h}, "
          f"bsz {BSZ}, tiles {TILE_W}x{TILE_H}: {n_isect} isects/cam "
          f"({n_kept} post-cull), capacity {isect_cap}/cam, blend "
          f"{blend_cap}/cam")

    # the blend's inputs exactly as render_batch builds them
    blend_in, blend_kw, n_univ = garden_blend_inputs(params, alive, scene, cfg)
    ids, px0, py0 = blend_in[4], blend_in[6], blend_in[7]
    tlo, thi = blend_kw["tile_lo"], blend_kw["tile_hi"]

    stamp(t_start, "inputs built")

    # --- 3. K3 against its plain version --------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    scan_shapes = [(1, n_univ), (4, BSZ * isect_cap)]   # per render_batch
    k3_err, n_checked = scan_stress(dev, gen, scan_shapes)
    print(f"# K3 scan: bit-equal to torch.cumsum in {n_checked} calls (tile "
          f"edges at C 1, 4, 8; the main path's shapes; odd lengths; 1,000 "
          f"back to back on one scratch; across the epoch's wrap)")

    # --- 4. K1 and K2 against their plain versions ------------------------
    n_slots, n_px = BSZ * cfg.num_tiles, TILE_W * TILE_H
    col_k, t_k, bwd_kw, k1_err, k2_err = blend_check(
        "the garden's tile lists", blend_in, blend_kw,
        torch.randn((n_slots, n_px, 3), generator=gen, device=dev),
        torch.randn((n_slots, n_px), generator=gen, device=dev))

    # the saturating scene, then other tile shapes: K2 picks 2 pixels a
    # thread on 32x8 tiles and 1 on 64x4 (8x4 warp patches) and 128x2 (16x2)
    for what, kw in (("a saturating scene", {}),
                     ("a small scene, 32x8 tiles",
                      dict(tile_w=32, tile_h=8, w=128, opacity=None)),
                     ("a small scene, 64x4 tiles",
                      dict(tile_w=64, tile_h=4, w=128, opacity=None)),
                     ("a small scene, 128x2 tiles",
                      dict(tile_w=128, tile_h=2, w=128, opacity=None))):
        s_in, s_kw = small_blend_inputs(dev, **kw)
        s_px = (s_in[6].shape[0], s_in[8] * s_in[9])    # (slots, pixels)
        _, t_s, _, s_k1_err, s_k2_err = blend_check(
            what, s_in, s_kw,
            torch.randn(s_px + (3,), generator=gen, device=dev),
            torch.randn(s_px, generator=gen, device=dev))
        if not kw:
            require(float(t_s.min()) < 2e-4, "the saturating scene did not "
                    f"saturate: min final_t {float(t_s.min())}")
        k1_err, k2_err = max(k1_err, s_k1_err), max(k2_err, s_k2_err)
    # K1 alone on a tile whose pixel count (120) is not a multiple of 32:
    # K2 refuses it, and K1 walks one pixel a thread without the reject
    s_in, s_kw = small_blend_inputs(dev, tile_w=12, tile_h=10, opacity=None)
    k1_err = max(k1_err, k1_check("a small scene, 12x10 tiles", s_in,
                                  s_kw)[2])

    stamp(t_start, "K1 and K2 checked")

    # --- 5. the render path ----------------------------------------------
    bg = torch.tensor([0.0, 0.0, 0.0], device=dev)
    k3.launches = k1.launches = k2.launches = 0
    imgs, _, aux = R.render_batch(params, alive, cams, sh, cfg, bg=bg)
    torch.cuda.synchronize()
    render_launches = {"K1": k1.launches, "K3": k3.launches}
    print(f"# render path launches: {render_launches}")
    require(all(n > 0 for n in render_launches.values()),
            f"a kernel of the render path did not launch: {render_launches}")
    require(imgs.shape == (BSZ, 3, h, w), f"image shape {tuple(imgs.shape)}")
    require(bool(torch.isfinite(imgs).all()), "non-finite image")
    require(int(aux.num_isects[0]) <= BSZ * isect_cap,
            f"isect overflow {int(aux.num_isects[0])} > {BSZ * isect_cap}")
    mean = float(imgs.mean())
    print(f"# render_batch image mean {mean:.4f}, final_t mean "
          f"{float(aux.final_t.mean()):.4f}")
    require(0.02 < mean < 0.98, f"image mean {mean} outside (0.02, 0.98)")
    # the render path's blend is the kernel run checked in phase 4
    require(torch.equal(imgs[0], R.slots_to_images(
        col_k + t_k[..., None] * bg, t_k, BSZ, tiles_y, tiles_x, TILE_H,
        TILE_W, h, w)[0][0]), "render_batch image differs from phase 4")
    # a small scene on the card against the plain CPU reference
    fields, al = params_fields(*random_gaussians(1, 300, sh_degree=3), 512)
    small = [make_test_camera(160, 128, angle=0.3 * i) for i in range(2)]
    small_cfg = R.RenderConfig(img_h=128, img_w=160, tile_w=TILE_W,
                               tile_h=TILE_H, isect_capacity=8192,
                               max_per_tile=512)
    bg_s = torch.tensor([0.2, 0.1, 0.3])
    on_card = R.render_batch(*params_from_numpy(fields, al, dev),
                             batch_camera_arrays(small, dev), 3, small_cfg,
                             bg=bg_s.to(dev))[0].cpu()
    on_cpu = R.render_batch(*params_from_numpy(fields, al, "cpu"),
                            batch_camera_arrays(small, "cpu"), 3,
                            small_cfg._replace(backend="torch"), bg=bg_s)[0]
    small_err = float((on_card - on_cpu).abs().max())
    print(f"# small scene, card vs CPU reference: max abs err {small_err:.3e}")
    require(small_err <= 1e-4, f"card render differs from CPU: {small_err}")

    stamp(t_start, "render path checked")

    # --- 6. the training path (the main path) ------------------------------
    tr = garden_training(seed=0, device=dev)
    require(tr.cfg == cfg, "garden_training sized another render config")
    kernels_of = {"K1": k1, "K2": k2, "K3": k3}
    state, losses, launches = train_phase(kernels_of, tr, TRAIN_STEPS)
    print(f"# training path, {TRAIN_STEPS} steps: launches {launches}, loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}")
    require(losses[-1] < losses[0],
            f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    require(all(bool(torch.isfinite(p).all()) for p in state.params),
            "non-finite parameter after training")
    require(int(state.iteration) == BSZ * TRAIN_STEPS
            and int(state.adam.count) == TRAIN_STEPS,
            f"iteration {int(state.iteration)}, Adam count "
            f"{int(state.adam.count)}")
    # one small step on the card against the same step on the CPU
    inputs = flagship_inputs(seed=0)
    on_card, on_cpu = (flagship_training(inputs, d) for d in (dev, "cpu"))
    s_card, m_card = on_card.step(on_card.state)
    s_cpu, m_cpu = on_cpu.step(on_cpu.state)
    loss_rel = abs(float(m_card["loss"]) / float(m_cpu["loss"]) - 1.0)
    # one step from a fresh state leaves moments far below 1e-4, so each
    # leaf is also held scaled by its largest value on the CPU: that holds
    # the card's whole backward (K2, projection, SH, SSIM) to the CPU's
    mom_err = 0.0
    for name, mc, mp in zip(
            [f"mu.{k}" for k in s_cpu.params._fields]
            + [f"nu.{k}" for k in s_cpu.params._fields],
            s_card.adam.mu + s_card.adam.nu, s_cpu.adam.mu + s_cpu.adam.nu):
        mc = mc.cpu()
        require(torch.allclose(mc, mp, atol=1e-4, rtol=1e-3),
                f"Adam moment {name} on the card differs from the CPU")
        require(float(mp.abs().max()) > 0, f"Adam moment {name} is zero")
        err = rel_err(mc, mp)
        require(err <= MOMENT_REL_TOL,
                f"Adam moment {name}: card vs CPU err / max {err:.3e} > "
                f"{MOMENT_REL_TOL}")
        mom_err = max(mom_err, err)
    print(f"# small train_step, card vs CPU: loss relative err "
          f"{loss_rel:.3e}, Adam moments max err / max {mom_err:.3e} "
          f"(limit {MOMENT_REL_TOL})")
    require(loss_rel <= 1e-5, f"card loss differs from CPU: {loss_rel}")

    stamp(t_start, "training path checked")

    # --- host-clock timings of the render and the step: before phases 7
    # and 8, in the process state in which the earlier slices took them ----
    walls = host_walls(lambda: R.render_batch(params, alive, cams, sh, cfg,
                                              bg=bg), 20)
    render_ms = statistics.median(walls)
    print(f"# render_batch bsz {BSZ} {w}x{h}: median {render_ms:.3f} ms "
          f"(min {min(walls):.3f}, max {max(walls):.3f}) over 20 calls "
          f"= {BSZ * 1e3 / render_ms:.1f} images/s {tag}")
    profile(lambda: R.render_batch(params, alive, cams, sh, cfg, bg=bg), 5)

    holder = [state]

    def one_step():
        holder[0], _ = tr.step(holder[0])

    walls = host_walls(one_step, 20)
    step_ms = statistics.median(walls)
    print(f"# train_step bsz {BSZ} {w}x{h}: median {step_ms:.3f} ms "
          f"(min {min(walls):.3f}, max {max(walls):.3f}) over 20 calls "
          f"= {BSZ * 1e3 / step_ms:.1f} images/s {tag}")
    print("# train_step profile:")
    step_dev_ms, rows = profile(one_step, 5)
    per_kernel = {k: sum(n for _, n, key in rows if name in key)
                  for k, name in (("K1", "rasterize_fwd"),
                                  ("K2", "rasterize_bwd"), ("K3", "scan"))}
    print(f"# train_step device time per step: {step_dev_ms:.3f} ms (the "
          f"profiler's sum over its kernels, 5 steps); launches per step "
          f"{per_kernel} {tag}")
    # the step's layers alone, host clock: the loss (forward and backward
    # on a fixed image) and the Adam update; the render's forward and
    # backward, the densify statistics and autograd take the rest
    img = torch.rand((BSZ, 3, h, w), device=dev, generator=gen,
                     requires_grad=True)
    gt = tr.gt_u8.to(torch.float32) / 255.0

    def loss_fwd_bwd():
        loss, _ = batch_loss(img, gt, tr.lambda_dssim)
        torch.autograd.grad(loss, [img])

    st = holder[0]
    zero_grads = GaussianParams(*(torch.zeros_like(p) for p in st.params))
    loss_ms = statistics.median(host_walls(loss_fwd_bwd, 20))
    adam_ms = statistics.median(host_walls(
        lambda: adam_step(st.params, zero_grads, st.adam, tr.lrs,
                          tr.xyz_sched(st.iteration), st.alive), 20))
    print(f"# train_step layers, host clock median of 20: loss fwd+bwd "
          f"{loss_ms:.3f} ms, Adam {adam_ms:.3f} ms, render fwd+bwd and "
          f"the rest {step_ms - loss_ms - adam_ms:.3f} ms {tag}")
    torch.cuda.reset_peak_memory_stats()
    one_step()
    torch.cuda.synchronize()
    print(f"# train_step peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    stamp(t_start, "render and step timed")

    # --- 7. the host training loop (this slice's main path) ---------------
    with tempfile.TemporaryDirectory(dir=ROOT / "output") as tmp:
        loop_launches, loop_errs, step_k2_in = loop_path(
            dev, tag, kernels_of, LOOP_SCENE, tmp)
    if args.save_k2:
        tile_in = blend_in[:5] + (blend_kw["tile_lo"], blend_kw["tile_hi"])
        torch.save(tile_in + blend_in[6:] + (
            bwd_kw["c_total"], bwd_kw["final_t"], bwd_kw["g"], bwd_kw["g_t"]),
            os.path.join(args.save_k2, "k2_garden.pt"))
        torch.save(step_k2_in, os.path.join(args.save_k2, "k2_step.pt"))
    stamp(t_start, "host training loop checked")

    # --- 8. the DMA microbenchmark's kernels and the microbenchmark -------
    odd_errs = dma_check(dev)
    dma_launches, dma_results, dma_errs = dma_path(dev, tag)
    dma_errs = {k: max(e, odd_errs[k]) for k, e in dma_errs.items()}
    stamp(t_start, "DMA microbenchmark checked")
    # the same step again in the process the loop and the microbenchmark
    # leave behind
    walls = host_walls(one_step, 20)
    print(f"# train_step after phases 7 and 8: median "
          f"{statistics.median(walls):.3f} ms (min {min(walls):.3f}, max "
          f"{max(walls):.3f}) over 20 calls {tag}")

    # --- 9. kernel timings -------------------------------------------------
    timer = Timer()
    k1_ms = timer.ms(lambda: k1(*blend_in, **blend_kw), 20)
    k1_dev_ms = timer.device_ms(lambda: k1(*blend_in, **blend_kw), 20)
    k1_plain_ms = timer.ms(lambda: rasterize_slots(*blend_in, **blend_kw), 3)
    pairs, blended = walked_pairs(blend_in[0], blend_in[1], blend_in[3],
                                  ids, tlo, thi, px0, py0)
    entries = int((torch.minimum(thi, tlo + MAX_PER_TILE) - tlo).sum())
    m = blend_in[0].shape[0]
    n_pix = t_k.numel()
    splat_bytes = m * 9 * 4 + ids.numel() * 4 + 4 * tlo.numel() * 4
    k1_bytes = splat_bytes + n_pix * 4 * 4
    k1_bytes_ms = 1e3 * k1_bytes / HBM_BYTES_PER_S
    k1_ops_ms = 1e3 * K1_OPS_PER_PAIR * pairs / FP32_OPS_PER_S
    k1_bound = max(k1_bytes_ms, k1_ops_ms)
    k1_bound_by = "operations" if k1_ops_ms >= k1_bytes_ms else "bytes"
    print(f"# K1: {entries} entries walked in spans, {pairs} (entry, pixel) "
          f"pairs to stop, {blended} blended, {k1_bytes} bytes; {k1_ms:.4f} "
          f"ms (device alone {k1_dev_ms:.4f} ms), plain {k1_plain_ms:.2f} "
          f"ms, bound {k1_bound:.4f} ms "
          f"({k1_bound_by}) {tag}")

    k2_ms = timer.ms(lambda: k2(*blend_in, **bwd_kw), 20)
    k2_dev_ms = timer.device_ms(lambda: k2(*blend_in, **bwd_kw), 20)
    k2_plain_ms = timer.ms(lambda: rasterize_slots_bwd(*blend_in, **bwd_kw),
                           1)
    # inputs: the splats, ids and spans, c_total, final_t and the two
    # cotangents (8 floats per pixel); output: 9 floats per Gaussian
    k2_bytes = splat_bytes + n_pix * 8 * 4 + m * 9 * 4
    k2_bytes_ms = 1e3 * k2_bytes / HBM_BYTES_PER_S
    k2_ops = K1_OPS_PER_PAIR * pairs + K2_OPS_PER_BLENDED * blended
    k2_ops_ms = 1e3 * k2_ops / FP32_OPS_PER_S
    k2_bound = max(k2_bytes_ms, k2_ops_ms)
    k2_bound_by = "operations" if k2_ops_ms >= k2_bytes_ms else "bytes"
    print(f"# K2: {k2_ops} operations, {k2_bytes} bytes; {k2_ms:.4f} ms "
          f"(device alone {k2_dev_ms:.4f} ms), plain {k2_plain_ms:.2f} ms, "
          f"bound {k2_bound:.4f} ms "
          f"({k2_bound_by}) {tag}")
    # K1 and K2 on the inputs of the loop's last step: a trained scene
    # blends far more of its walked pairs than the random garden
    (m2d, con, col, op, sids, slo, shi, spx0, spy0, stw, sth, smpt, sc, sft,
     sg, sgt) = step_k2_in
    step_in = (m2d, con, col, op, sids, None, spx0, spy0, stw, sth, smpt)
    step_fwd_kw = dict(tile_lo=slo, tile_hi=shi)
    step_kw = dict(step_fwd_kw, c_total=sc, final_t=sft, g=sg, g_t=sgt)
    s_pairs, s_blended = walked_pairs(m2d, con, op, sids, slo, shi, spx0,
                                      spy0, stw, sth, smpt)
    k1_step_ms = timer.ms(lambda: k1(*step_in, **step_fwd_kw), 20)
    k1_step_dev_ms = timer.device_ms(lambda: k1(*step_in, **step_fwd_kw), 20)
    s1_bytes = (m2d.shape[0] * 9 * 4 + sids.numel() * 4 + 4 * slo.numel() * 4
                + sft.numel() * 4 * 4)
    s1_bound = max(1e3 * s1_bytes / HBM_BYTES_PER_S,
                   1e3 * K1_OPS_PER_PAIR * s_pairs / FP32_OPS_PER_S)
    print(f"# K1 on a loop step ({sft.shape[0]} slots, {m2d.shape[0]} "
          f"splats): {s_pairs} pairs walked; {k1_step_ms:.4f} ms (device "
          f"alone {k1_step_dev_ms:.4f} ms), bound {s1_bound:.4f} ms {tag}")
    k2_step_ms = timer.ms(lambda: k2(*step_in, **step_kw), 20)
    k2_step_dev_ms = timer.device_ms(lambda: k2(*step_in, **step_kw), 20)
    s_bytes = (m2d.shape[0] * 18 * 4 + sids.numel() * 4 + 4 * slo.numel() * 4
               + sft.numel() * 8 * 4)
    s_ops = K1_OPS_PER_PAIR * s_pairs + K2_OPS_PER_BLENDED * s_blended
    s_bound = max(1e3 * s_bytes / HBM_BYTES_PER_S,
                  1e3 * s_ops / FP32_OPS_PER_S)
    print(f"# K2 on a loop step ({sft.shape[0]} slots, {m2d.shape[0]} "
          f"splats): {s_pairs} pairs walked, {s_blended} blended "
          f"({s_blended / max(s_pairs, 1):.1%}), {s_ops} operations; "
          f"{k2_step_ms:.4f} ms (device alone {k2_step_dev_ms:.4f} ms), "
          f"bound {s_bound:.4f} ms {tag}")

    # K3 per shape; its library time is the one PyTorch call that computes
    # the same function: torch.cumsum of the one channel at C=1, of the
    # stacked channels at C=4 (the plain version is one call per channel);
    # on both clocks, beside the host's time to enqueue one call of each
    k3_row = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "library_ms": 0.0}
    for c, m_len in scan_shapes:
        xs = [torch.randint(0, 64, (m_len,), generator=gen, device=dev,
                            dtype=torch.int32) for _ in range(c)]
        stacked = torch.stack(xs)
        lib = ((lambda: torch.cumsum(xs[0], 0, dtype=torch.int32)) if c == 1
               else (lambda: torch.cumsum(stacked, 1, dtype=torch.int32)))
        row = {
            "ms": timer.ms(lambda: k3(xs), 50),
            "device_ms": timer.device_ms(lambda: k3(xs), 50),
            "plain_ms": timer.ms(
                lambda: scan_cuda.cumsum_i32_multi_plain(xs), 50),
            "library_ms": timer.ms(lib, 50),
            "bound_ms": 1e3 * 2 * c * m_len * 4 / HBM_BYTES_PER_S,
        }
        lib_dev_ms = timer.device_ms(lib, 50)
        k3_host, lib_host = host_us(lambda: k3(xs)), host_us(lib)
        print(f"# K3 C={c} M={m_len}: {row['ms']:.4f} ms (device alone "
              f"{row['device_ms']:.4f} ms; host {k3_host:.2f} us a call), "
              f"plain ({c} torch.cumsum) {row['plain_ms']:.4f} ms, library "
              f"(torch.cumsum {'of the channel' if c == 1 else 'stacked'}) "
              f"{row['library_ms']:.4f} ms (device alone {lib_dev_ms:.4f} "
              f"ms; host {lib_host:.2f} us a call), bound "
              f"{row['bound_ms']:.4f} ms (bytes) {tag}")
        for k in k3_row:
            k3_row[k] += row[k]
    k4_row, k5_row = dma_rows(dev, timer, tag, dma_results)
    stamp(t_start, "timings done")

    # ms: the clock of the kernels line, on which the card may wait for
    # the host to reach the launch; device_ms: the device's time alone.
    # launches: K1-K3 over the host training loop's steps, K4 and K5 over
    # the microbenchmark's run; max_abs_err: the larger of the checks on
    # the garden's inputs and on a loop step's (K1-K3), and of the
    # microbenchmark's own check and the odd chunk count's (K4, K5)
    kernels_line = {"kernels": [
        {"name": "rasterize_fwd", "route": "cuda",
         "source": "grendel_tpu_torch/csrc/rasterize_fwd.cu",
         "replaces": "grendel_tpu/ops/rasterize_pallas.py:181",
         "launches": loop_launches["K1"],
         "max_abs_err": max(k1_err, loop_errs["K1"]),
         "ms": k1_ms, "device_ms": k1_dev_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_bound_by, "library_ms": None},
        # K3's times are per render_batch (a train_step builds its tile
        # lists once, at the same two shapes): the sum over both launches,
        # the library's of the one call per shape
        {"name": "scan_i32", "route": "cuda",
         "source": "grendel_tpu_torch/csrc/scan.cu",
         "replaces": "grendel_tpu/ops/scan_pallas.py:65",
         "launches": loop_launches["K3"],
         "max_abs_err": max(k3_err, loop_errs["K3"]),
         "ms": k3_row["ms"], "device_ms": k3_row["device_ms"],
         "plain_ms": k3_row["plain_ms"],
         "bound_ms": k3_row["bound_ms"], "bound_by": "bytes",
         "library_ms": k3_row["library_ms"]},
        {"name": "rasterize_bwd", "route": "cuda",
         "source": "grendel_tpu_torch/csrc/rasterize_bwd.cu",
         "replaces": "grendel_tpu/ops/rasterize_pallas.py:262",
         "launches": loop_launches["K2"],
         "max_abs_err": max(k2_err, loop_errs["K2"]),
         "ms": k2_ms, "device_ms": k2_dev_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_bound_by, "library_ms": None},
        # library: torch.sum over the int32 view (K4), the PyTorch row
        # gather table[ids].sum() (K5)
        {"name": "dma_contig", "route": "cuda",
         "source": "grendel_tpu_torch/csrc/dma_bench.cu",
         "replaces": "scripts/microbench_dma.py:98",
         "launches": dma_launches["K4"],
         "max_abs_err": dma_errs["dma_contig"], **k4_row,
         "bound_by": "bytes"},
        {"name": "dma_scattered", "route": "cuda",
         "source": "grendel_tpu_torch/csrc/dma_bench.cu",
         "replaces": "scripts/microbench_dma.py:126",
         "launches": dma_launches["K5"],
         "max_abs_err": dma_errs["dma_scattered"], **k5_row,
         "bound_by": "bytes"},
    ]}
    print(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
