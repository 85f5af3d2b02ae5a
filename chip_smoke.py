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
     tile lists: max abs error <= 1e-5 on colors and on final_t; the
     backward (kernel K2's per-entry rows, summed per Gaussian by kernel
     K2s) against its plain version on the same lists with random
     cotangents: every output finite, and max |K2 - plain| <= 1e-4 max
     |plain| for each (the slack covers the order of the sums inside a
     slot, which the two take differently); launched again, bit-equal to
     itself; K2s on K2's rows bit-equal to its plain version (index_add_
     on the CPU in entry order); all again on a saturating scene (opacity
     0.999, 16x16
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
     loss to 1e-5 relative, Adam moments to atol 1e-4, rtol 1e-3; the 10
     steps run twice more from the first step's state must give
     bit-equal losses and state leaves (K1, K2 and K2s launched in every
     step: the launch counters cover K2s wherever they cover K2);
  7. the host training loop at full width, this slice's main path:
     Trainer on the raytraced StructuredSyntheticScene (1280x832, 8 train
     and 2 held-out views, 100,000 initial points), bsz 2 for 300
     iterations with densify rounds at 200 and 300, an opacity reset at
     200 and checkpoints at 200 and 300; the launch counters must show
     K1, K2 and K3 in every step, and the run must densify with clones or
     splits at least twice, grow the capacity, reset the opacity, keep
     every parameter finite, raise the held-out PSNR, and resume from its
     iteration-200 checkpoint for two more steps; K1, K2 and K3 are held
     against their plain versions, at phases 3-4's tolerances, on the
     inputs the loop's last step gave them (K2 on the loss's own
     cotangents); iterations/s, peak memory, wall and host enqueue time
     per step, the device time and launches per step of 5 more steps
     under the profiler with the host's time in CUDA runtime calls, and
     the synchronizing calls per step of 5 more;
  8. the DMA microbenchmark's kernels: K4 and K5 bit-equal to their plain
     versions at an odd chunk count (row widths 16 and 128, 0 and 24
     arithmetic rounds; ids -1 and past the table among K5's, which
     gather rows of zeros); then the microbenchmark itself at both row
     widths, which checks its own default sizes the same way before it
     times them, and whose launch counters must show K4 and K5;
  10. the distributed step (parallel/sharded.py) at full width, on the
     garden: DistributedTrainer on a one-rank NCCL group for 3 steps in
     each distribution mode, through the real all-to-all and all-reduce
     (K1, K2 and K3 in every step; step 1's loss within 1e-5 relative of
     train_step's, its Adam moments within 1e-3 of each leaf's largest; a
     render within 1e-5 of render_batch); then, since NCCL takes one rank
     per GPU, the flat path of more ranks simulated in one process
     (testing.simulate_distributed): D=2 split at the camera border, loss
     within 1e-5 relative and gradients within 1e-4 of each leaf's largest
     of train_step's; D=4 on an uneven division, its assembled render
     within 1e-5 of render_batch, and K1 and K2 held to their plain
     versions on each rank's flat tile lists; K3 bit-equal to its plain
     version on every scan of both simulations; each with its device time
     per step, launches and peak memory; the 3 steps of each mode, and
     each simulated step, run twice from one state: bit-equal losses,
     leaves, gradients and images;
  11. the distributed host loop: phase 7's scene and schedule through
     ``MultiRankTrainer`` on a one-rank NCCL group, which drives
     DistributedTrainer (engine/trainer_dist.py; replicated at world size
     1): K1, K2 and K3 in every step and held against their plain
     versions, at phases 3-4's tolerances, on the last step's inputs
     (its replicated row lists and the tall image's loss cotangents), the
     same densify, growth, reset and resume checks, step-0 L1 within 1e-5
     relative of phase 7's, held-out PSNR within 0.3 dB of phase 7's and
     n_alive within 2% of it (the two loops take different code paths;
     both repeat bit for bit, so the gap is the same on every run); its
     iterations/s, wall and host enqueue
     time per step, device time and launches per step, synchronizing
     calls per step (torch's sync debug mode) and peak memory printed
     beside phase 7's, and both loops timed again in alternation (one,
     distributed, distributed, one) in the same process;
  12. the tools on phase 7's trained model, as a user runs them after
     training: ckpt_to_ply of the iteration-300 checkpoint (the PLY's
     fields equal the checkpoint's); scripts/render.py through main(argv)
     over all 10 views at 1280x832, bsz 2 (K1 and K3 counted in every
     batch, and held against their plain versions, at phases 3-4's
     tolerances, on the first batch's inputs: 16x16 tiles on exact-size
     lists; each PNG within one level of 255 of render_batch's image of
     the view; ms per view); scripts/metrics.py on that tree with LPIPS
     on random weights made from a seed (test PSNR within 0.02 dB of
     Trainer.eval_psnr on the same model); LPIPS on the card within 1e-4
     relative of the CPU on one pair, with TF32 allowed outside it;
     scripts/profile_step.py at the garden shape (every stage finite and
     positive; K1-K3 launched where each stage runs them, and held
     against their plain versions on one full_step's inputs, K3 also on
     one isect call's), printed beside
     phase 9's train_step device time; a 30-iteration CLI run of the
     structured scene at 640x416 with --nsys_profile and
     --log_memory_summary (the trace names K1; three memory lines);
  13. the repo's 4K configuration (examples/structured_4k.sh) through the
     port's training CLI on the card: the raytraced structured scene at
     5184x3360, 200,000 initial points, bsz 1, 32x16 tiles, densify every
     100 from 100, 300 iterations, --check_gpu_memory
     --log_memory_summary; its views cut from 12 to 6 (5 training, 1 held
     out) for the host raytrace, printed on a ``# reduced:`` line. K1, K2
     and K3 in every step and held against their plain versions, at
     phases 3-4's tolerances, on the last step's inputs; every loss and
     parameter finite; a densify round that clones or splits; held-out
     PSNR rising; the entry ceiling read from the card logged and above
     2^22, and no step over capacity at it. Printed: entries a camera
     against the ceiling, the measured step's bytes and the loop's peak
     as shares of the card, the bytes a step takes per entry of capacity
     (its peak at four capacities; from 2^27 to 2^28 entries within 5%
     of utils/hbm.py BYTES_PER_ISECT_ENTRY), and a rank's on the flat
     row-span lists (a simulated D=2 step at 2^27 and 2^28 entries a
     rank; within 5% of BYTES_PER_FLAT_ENTRY), the int32 clamp of the
     ceiling beside it, the memory guard, iterations/s, the
     device time and launches per step (profiler, 3 steps), K1-K3 on the
     4K step against their bounds, the set-up (raytrace) and phase
     seconds. Then the same scene through ``MultiRankTrainer`` on a
     one-rank NCCL group for 10 iterations: K1-K3 in every step, its own
     ceiling above 2^22, its entries a rank beside it, no step over
     capacity at it;
  14. host-resident ground truth (the preload rule's other side):
     phase 7's views written as a COLMAP + PNG dataset and trained
     through the CLI's ``main(argv)`` with ``-s <dir> --eval``, 300
     iterations at bsz 2, once preloaded (the default threshold) and once
     at ``--preload_dataset_to_gpu_threshold 0``, where no ground-truth
     bank may exist and each step packs its batch on the host and uploads
     it: step-0 L1 equal within 1e-6 relative, held-out PSNR rising in
     both; the two runs do the same arithmetic on the same bytes, so every
     step's L1, the held-out PSNR and the alive count must be equal; K1-K3
     in every step and held against their
     plain versions on the host run's last step; iterations/s, both runs
     again in alternation, the ground-truth stage's host ms and its time
     on the loop's timer, synchronizing calls per step and peak memory of
     each. Then the dataset through ``MultiRankTrainer`` on a one-rank
     NCCL group, every camera lazy and the decode cache at 3 views, for
     100 iterations: decodes happen, the cache stays within its budget,
     step-0 L1 within 1e-5 relative of the first run's, PSNR rises;
     ``read_png``'s ms a view, and a row's on Paeth-filtered rows. Last,
     the one-device loop on an in-memory scene of 16 and of 1,600 views at
     1296x840 (ground truth from a cheap loader, about 5.2 GB of it) for 10
     iterations at threshold 0: peaks within 64 MiB of each other; and
     1,600 views preloaded: a peak higher by at least the bank; each
     run's entry ceiling printed;
  9. timings: render_batch and train_step (host clock, median of 20 after
     2 warm-ups, taken between phases 6 and 7; the step again after phase
     8), a profiler breakdown of each with the step's device time, and
     each kernel, its plain version and the library call (CUDA events,
     with the L2 cache flushed before each launch), beside the least time
     the card could take; each kernel also on the device's clock alone
     (``device_ms``: the host's time to reach the launch hidden); K2 alone
     and K2s on its rows, with the sort between them and the whole VJP
     printed; K1, K2 and K2s also on the loop step's inputs, K3 per shape
     with its wrapper's host time per call.

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

import numpy as np
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
# K2s's max abs error against its plain version in every check (each must
# be 0: both sum in entry order)
K2S_ERRS = []
# one small train_step, card vs CPU: each Adam moment leaf within this
# much of its largest value (the rtol of the whole-step gradient bound)
MOMENT_REL_TOL = 1e-3
TRAIN_STEPS = 10
# the host training loop: the structured scene and its schedule
LOOP_SCENE = dict(width=1280, height=832, n_cams=10, llffhold=5,
                  n_init_points=100_000, seed=0)
LOOP_ITERS, LOOP_CHECKPOINT, LOOP_RESUME_STEPS = 300, 200, 2
# the distributed step: steps in each distribution mode at world size 1
DIST_STEPS = 3
# the tools: the step profiler at the garden shape, and the CLI run's
# structured scene (a quarter of the loop's pixels: it raytraces its views)
TOOLS_PROFILE = dict(height=840, width=1296, n=200_000)
TOOLS_CLI_SIZE = "640x416"
# the 4K configuration (examples/structured_4k.sh) through the CLI; its 12
# views cut to 6 (the structured scene's fewest: 3 rings of 3, less one
# empty ring) for the host raytrace of the ground truth
FOURK_SIZE, FOURK_POINTS, FOURK_CAMS, FOURK_HOLD = "5184x3360", 200_000, 6, 8
FOURK_ITERS, FOURK_DIST_ITERS = 300, 10
# entry capacities at which the tile lists set a step's peak memory
FOURK_ENTRY_PROBE = 1 << 27
# host-resident ground truth (phase 14): the lazy run's iterations, and
# the memory runs' view counts (the second about 5.2 GB of uint8 ground
# truth at their size), iterations and initial points
STORAGE_LAZY_ITERS = 100
STORAGE_MEM_VIEWS, STORAGE_MEM_SIZE = (16, 1600), (1296, 840)
STORAGE_MEM_ITERS, STORAGE_MEM_POINTS = 10, 100_000
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


def profile(fn, calls, top=14, host_top=0):
    """Device time by kernel over ``calls`` calls of ``fn`` under
    torch.profiler, per call, and the share of the window's wall time the
    device was busy (the profiler's own overhead lengthens the window);
    with ``host_top``, also the host's time per call in that many of the
    costliest CUDA runtime calls (launches, copies, waits). Returns the
    device ms per call and the rows (ms, launches, name) per call."""
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
    if host_top:
        host = sorted(((e.self_cpu_time_total / 1e3 / calls, e.count / calls,
                        e.key) for e in prof.key_averages()
                       if e.key.startswith("cuda")), reverse=True)
        print(f"# host time in CUDA runtime calls: "
              f"{sum(h[0] for h in host):.3f} ms per call, the costliest:")
        for ms, n, key in host[:host_top]:
            print(f"#   {ms:8.4f} ms  {n:6.1f}x  {key[:90]}")
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


def sync_sites(fn):
    """Run ``fn`` under torch's CUDA sync debug mode; returns the count of
    synchronizing calls (an ``item``, a blocking copy) by the line of the
    port that made them. Waits on an event are not counted."""
    import collections
    import traceback
    import warnings

    sites = collections.Counter()
    pkg = str(ROOT / "grendel_tpu_torch")

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()
                if f.filename.startswith(pkg)]
        site = (f"{os.path.relpath(ours[-1].filename, ROOT)}:"
                f"{ours[-1].lineno}" if ours else f"{filename}:{lineno}")
        sites[site] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def alternating_walls(a, b, steps):
    """Host-clock ms per step of trainers ``a`` and ``b`` trained in the
    order a, b, b, a, ``steps`` steps each time (``train`` ends in a
    synchronize): the two loops in one process, its drift cancelled."""
    walls = {id(a): [], id(b): []}
    for tr in (a, b, b, a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train(int(tr.state.iteration) + steps * BSZ)
        walls[id(tr)].append((time.perf_counter() - t0) * 1e3 / steps)
    return walls[id(a)], walls[id(b)]


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
    within K1_TOL on colors and final_t; the backward (K2, then K2s on its
    rows) on the cotangents ``g`` and ``g_t`` finite, within K2_REL_TOL of
    each output's largest value, and bit-equal to itself when launched
    again; K2s on K2's rows bit-equal to its plain version, which sums
    them on the CPU in entry order (``K2S_ERRS`` keeps its max abs error).
    Returns K1's outputs, K2's keyword arguments and each kernel's max abs
    error."""
    from grendel_tpu_torch.ops.rasterize_cuda import (rasterize_slots_vjp,
                                                      rasterize_slots_vjp_rows,
                                                      segment_sum,
                                                      split_grads)
    from grendel_tpu_torch.ops.rasterize_torch import (rasterize_slots_bwd,
                                                       segment_sum_rows)

    col_k, t_k, k1_err = k1_check(what, blend_in, blend_kw)
    bwd_kw = dict(blend_kw, c_total=col_k, final_t=t_k, g=g, g_t=g_t)
    d_k = rasterize_slots_vjp(*blend_in, **bwd_kw)
    d_again = rasterize_slots_vjp(*blend_in, **bwd_kw)
    d_p = rasterize_slots_bwd(*blend_in, **bwd_kw)
    ids, m = blend_in[4], blend_in[0].shape[0]
    rows = rasterize_slots_vjp_rows(*blend_in, **bwd_kw)
    d_rows = segment_sum(rows, m, torch.sort(ids.to(torch.int32).contiguous(),
                                             stable=True))
    torch.cuda.synchronize()
    names = ("d_means2d", "d_conics", "d_colors", "d_opacities")
    require(all(bool(torch.isfinite(x).all()) for x in d_k),
            f"K2 output not finite ({what})")
    require(all(torch.equal(a, b) for a, b in zip(d_k, d_again))
            and all(torch.equal(a, b) for a, b in zip(d_k,
                                                      split_grads(d_rows))),
            f"K2 and K2s launched again differ from their first launch "
            f"({what})")
    k2_rel = {n: rel_err(a, b) for n, a, b in zip(names, d_k, d_p)}
    k2_err = max(float((a - b).abs().max()) for a, b in zip(d_k, d_p))
    print(f"# K2 backward blend ({what}): max |K2 - plain| / max |plain| "
          f"{ {n: f'{e:.3e}' for n, e in k2_rel.items()} }, max abs err "
          f"{k2_err:.3e} (tol {K2_REL_TOL} relative); launched again: "
          f"bit-equal")
    require(max(k2_rel.values()) <= K2_REL_TOL,
            f"K2 differs from its plain version ({what}): {k2_rel}")
    plain = segment_sum_rows(rows.cpu(), ids.cpu(), m)
    k2s_err = float((d_rows.cpu() - plain).abs().max()) if m else 0.0
    print(f"# K2s segment sum ({what}): {ids.shape[0]} entry rows into {m} "
          f"Gaussians, bit-equal to its plain version (index_add_ on the "
          f"CPU in entry order): {torch.equal(d_rows.cpu(), plain)}")
    require(torch.equal(d_rows.cpu(), plain),
            f"K2s differs from its plain version ({what}): {k2s_err}")
    K2S_ERRS.append(k2s_err)
    return col_k, t_k, bwd_kw, k1_err, k2_err


def state_leaves(x, name="state"):
    """(name, tensor) of every tensor in a nest of named tuples."""
    if torch.is_tensor(x):
        return [(name, x)]
    if isinstance(x, tuple):
        fields = getattr(x, "_fields", range(len(x)))
        return [leaf for i, f in enumerate(fields)
                for leaf in state_leaves(x[i], f"{name}.{f}")]
    return []


def clone_state(x):
    """A copy of a nest of named tuples of tensors."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone_state(v) for v in x))
    return x


def repeat_check(what, run, state):
    """``run`` twice from copies of ``state``, each returning (a state or
    nest of tensors, the losses): every leaf and every loss must be
    bit-equal between the two. Returns the number of leaves compared."""
    outs = []
    for _ in range(2):
        outs.append(run(clone_state(state)))
        torch.cuda.synchronize()
    (a, la), (b, lb) = outs
    leaves_a, leaves_b = state_leaves(a), state_leaves(b)
    differ = [n for (n, x), (_, y) in zip(leaves_a, leaves_b)
              if not torch.equal(x, y)]
    print(f"# determinism ({what}): two runs from one state, "
          f"{len(leaves_a)} leaves and {len(la)} losses compared, "
          f"leaves that differ: {differ}, losses equal: {la == lb}")
    require(len(leaves_a) == len(leaves_b) and not differ and la == lb,
            f"two runs from one state differ ({what}): {differ}, losses "
            f"{la} vs {lb}")
    return len(leaves_a)


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


def loop_config(model_path, iterations=LOOP_ITERS,
                checkpoints=(LOOP_CHECKPOINT,)):
    """The loop's schedule: bsz 2, densify every 100 from 100 to
    ``iterations``, an opacity reset every 200, a checkpoint at each of
    ``checkpoints`` (200), no eval or PLY save."""
    from grendel_tpu_torch.config import TrainConfig

    cfg = TrainConfig()
    cfg.model.model_path = model_path
    cfg.dist.bsz = BSZ
    o = cfg.opt
    o.iterations = iterations
    o.densify_from_iter, o.densification_interval = 100, 100
    o.densify_until_iter = iterations
    o.opacity_reset_interval = 200
    cfg.checkpoint_iterations = list(checkpoints)
    cfg.test_iterations, cfg.save_iterations = [], []
    cfg.log_interval = 50
    return cfg.finalize()


def capture_kernel_inputs(calls):
    """Within the ``with`` block, record what the path hands K1 (its
    inputs and outputs), K2 (its inputs, which are K1's, K1's outputs and
    the loss's cotangents) and K3 (its int32 channels) in ``calls["K1"]``,
    ``calls["K2"]`` and ``calls["K3"]``. The kernels still run, and count
    their launches, as they would."""
    import contextlib

    from grendel_tpu_torch.ops import isect as I
    from grendel_tpu_torch.ops import rasterize_cuda

    real = (rasterize_cuda._blend_vjp, I.cumsum_i32_multi, I.cumsum_i32,
            rasterize_cuda._blend)

    def blend(*args):
        out = real[3](*args)
        calls["K1"].append(tuple(a.detach() if torch.is_tensor(a) else a
                                 for a in args + out))
        return out

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
        calls["K1"], calls["K2"], calls["K3"] = [], [], []
        (rasterize_cuda._blend_vjp, I.cumsum_i32_multi, I.cumsum_i32,
         rasterize_cuda._blend) = blend_vjp, scan_multi, scan_one, blend
        try:
            yield
        finally:
            (rasterize_cuda._blend_vjp, I.cumsum_i32_multi, I.cumsum_i32,
             rasterize_cuda._blend) = real
    return patched()


def captured_k1_checks(what, calls_k1):
    """K1 against its plain version on the inputs of each captured K1
    call (K1 run again must give what the path got). Returns K1's max abs
    error."""
    k1_err = 0.0
    for i, (m2d, con, col, op, ids, lo, hi, px0, py0, tw, th, mpt, c_total,
            final_t) in enumerate(calls_k1):
        col_k, t_k, e1 = k1_check(
            f"{what}, call {i + 1} of {len(calls_k1)}",
            (m2d, con, col, op, ids, None, px0, py0, tw, th, mpt),
            dict(tile_lo=lo, tile_hi=hi))
        require(torch.equal(col_k, c_total) and torch.equal(t_k, final_t),
                f"K1 run again differs from the path's ({what})")
        k1_err = max(k1_err, e1)
    return k1_err


def captured_blend_checks(what, calls_k2):
    """K1 and K2 against their plain versions on the inputs each captured
    K2 call was given (K2 on the loss's own cotangents; K1 run again must
    give the forward the step used). Returns each kernel's max abs
    error."""
    k1_err = k2_err = 0.0
    for i, (m2d, con, col, op, ids, lo, hi, px0, py0, tw, th, mpt, c_total,
            final_t, g, g_t) in enumerate(calls_k2):
        blend_in = (m2d, con, col, op, ids, None, px0, py0, tw, th, mpt)
        col_k, t_k, _, e1, e2 = blend_check(
            f"{what}, call {i + 1} of {len(calls_k2)}", blend_in,
            dict(tile_lo=lo, tile_hi=hi), g, g_t)
        require(torch.equal(col_k, c_total) and torch.equal(t_k, final_t),
                f"K1 run again differs from the step's forward ({what})")
        k1_err, k2_err = max(k1_err, e1), max(k2_err, e2)
    return k1_err, k2_err


def loop_kernel_checks(calls, what="a loop step"):
    """K1, K2 and K3 against their plain versions on the inputs one
    training step (``what``) gave them. Returns each kernel's max abs
    error."""
    require(len(calls["K2"]) == 1 and calls["K3"],
            f"captured {len(calls['K2'])} K2 and {len(calls['K3'])} K3 "
            f"calls in {what}")
    k1_err, k2_err = captured_blend_checks(f"{what}'s tile lists",
                                           calls["K2"])
    k3_err = scan_check(what, calls["K3"])
    print(f"# K3 scan ({what}): bit-equal to plain in "
          f"{len(calls['K3'])} calls")
    return {"K1": k1_err, "K2": k2_err, "K3": k3_err}


def train_loop(trainer, tag, kernels_of, iterations, what, calls=None):
    """Train ``trainer`` from its iteration to ``iterations`` as a user
    does, zeroing every launch counter just before each step and reading
    it just after (every step must launch every kernel); with ``calls``,
    capture the last step's kernel inputs there. Then profile 5 more steps
    (no densify or reset falls in them). Returns the run's record."""
    first = int(trainer.state.iteration)
    n_steps = (iterations - first) // BSZ
    totals = {name: 0 for name in kernels_of}
    losses, l1s = [], []
    real_step = trainer._step

    enqueue_ms = []

    def step(*args):
        for wrapper in kernels_of.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        if calls is not None and len(losses) == n_steps - 1:
            with capture_kernel_inputs(calls):
                state, metrics = real_step(*args)
        else:
            state, metrics = real_step(*args)
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        n = {name: w.launches for name, w in kernels_of.items()}
        require(all(v > 0 for v in n.values()),
                f"{what} step {len(losses) + 1}: a kernel did not launch: "
                f"{n}")
        for name in totals:
            totals[name] += n[name]
        losses.append(metrics["loss"])
        l1s.append(metrics["l1"].sum())
        return state, metrics

    trainer._step = step
    scene = trainer.scene
    psnr_before = trainer.eval_psnr(scene.test_cameras, 0)
    cap0 = trainer.capacity
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the loop's own memory: the peak above what earlier phases hold
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = trainer.train(iterations)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    # the loop resets the allocator's peak to read its steps' memory, and
    # keeps the running maximum across those resets
    peak_gib = (trainer.peak_memory()[0] - base) / 2**30
    train_secs = trainer.end2end.total_seconds()
    losses = torch.stack(losses).cpu()
    psnr_after = trainer.eval_psnr(scene.test_cameras, 0)
    n_alive = trainer._n_alive()
    rec = dict(launches=totals, l1_0=float(l1s[0]), peak_gib=peak_gib,
               ips=(iterations - first) / train_secs, n_alive=n_alive,
               psnr_before=psnr_before["psnr"], psnr_after=psnr_after["psnr"],
               enqueue_ms=statistics.median(enqueue_ms),
               wall_ms=1e3 * train_secs / n_steps)
    print(f"# {what}: {iterations - first} iterations ({len(losses)} steps) "
          f"in {secs:.2f} s, {train_secs:.2f} s without checkpoint saves = "
          f"{rec['ips']:.2f} iterations/s, peak device memory "
          f"{peak_gib:.2f} GiB above the {base / 2**30:.2f} GiB held before "
          f"it; per step {rec['wall_ms']:.3f} ms of wall, of which the host "
          f"took {rec['enqueue_ms']:.3f} ms (median) to enqueue the step "
          f"{tag}")
    print(f"# {what}: launches {totals}; loss {float(losses[0]):.5f} -> "
          f"{float(losses[-1]):.5f}, step-0 L1 {rec['l1_0']:.7f}; capacity "
          f"{cap0} -> {trainer.capacity}, events {trainer.capacity_events}; "
          f"opacity resets at {trainer.opacity_reset_iters}; {n_alive} alive")
    for r in trainer.densify_history:
        print(f"# {what} densify: {r}")
    print(f"# {what} held-out PSNR {psnr_before['psnr']:.3f} -> "
          f"{psnr_after['psnr']:.3f} dB, L1 {psnr_before['l1']:.5f} -> "
          f"{psnr_after['l1']:.5f} ({psnr_after['n']} views)")
    require(len(losses) == n_steps and int(state.iteration) == iterations,
            f"{what} ran {len(losses)} steps to iteration "
            f"{int(state.iteration)}")
    require(bool(torch.isfinite(losses).all()), f"non-finite {what} loss")
    require(all(bool(torch.isfinite(p).all()) for p in state.params),
            f"non-finite parameter after the {what}")
    grew = sum(r["clone"] + r["split"] > 0 for r in trainer.densify_history)
    require(grew >= 2, f"{what}: fewer than two densify rounds cloned or "
            f"split: {trainer.densify_history}")
    require(("capacity_grow" in [k for k, _ in trainer.capacity_events])
            and trainer.capacity > cap0, f"{what}: the capacity never grew")
    require(bool(trainer.opacity_reset_iters), f"{what}: no opacity reset")
    require(n_alive == trainer.densify_history[-1]["alive"],
            f"{what}: alive count differs from the last densify's")
    require(psnr_after["psnr"] > psnr_before["psnr"],
            f"{what}: held-out PSNR did not rise: {psnr_before} -> "
            f"{psnr_after}")
    trainer._step = real_step
    print(f"# {what} step profile:")
    rec["dev_ms"], rows = profile(
        lambda: trainer.train(int(trainer.state.iteration) + BSZ), 5,
        host_top=6)
    rec["step_launches"] = kernel_launches(rows)
    print(f"# {what} device time per step {rec['dev_ms']:.3f} ms, launches "
          f"per step {rec['step_launches']}, {sum(r[1] for r in rows):.0f} "
          f"in all {tag}")
    sites = sync_sites(
        lambda: trainer.train(int(trainer.state.iteration) + 5 * BSZ))
    rec["syncs"] = sum(sites.values()) / 5
    print(f"# {what}: {rec['syncs']:.1f} synchronizing calls per step over 5 "
          f"steps (torch.cuda sync debug mode), by site: {dict(sites)}")
    return rec


def resume_check(trainer, dev, what):
    """Resume ``trainer``'s run from its mid-run checkpoint (its own
    kind of Trainer, with densification off) and take two more steps."""
    import dataclasses

    cfg = trainer.cfg
    ckpt = os.path.join(cfg.model.model_path, "checkpoints",
                        str(LOOP_CHECKPOINT))
    require(os.path.isdir(ckpt), f"{what}: no checkpoint {ckpt}")
    cfg2 = dataclasses.replace(cfg, start_checkpoint=ckpt,
                               checkpoint_iterations=[])
    cfg2.opt = dataclasses.replace(cfg.opt, densify_from_iter=10 ** 9,
                                   densify_until_iter=0)
    resumed = type(trainer)(cfg2, trainer.scene, device=dev)
    require(int(resumed.state.iteration) == LOOP_CHECKPOINT,
            f"{what}: resumed at iteration {int(resumed.state.iteration)}")
    st = resumed.train(LOOP_CHECKPOINT + LOOP_RESUME_STEPS * BSZ)
    require(int(st.iteration) == LOOP_CHECKPOINT + LOOP_RESUME_STEPS * BSZ
            and all(bool(torch.isfinite(p).all()) for p in st.params),
            f"{what}: resume reached iteration {int(st.iteration)}")
    print(f"# {what} resumed from {os.path.basename(ckpt)}: iteration "
          f"{LOOP_CHECKPOINT} -> {int(st.iteration)}, {int(st.alive.sum())} "
          f"alive")


def loop_path(dev, tag, kernels_of, scene_kw, model_path,
              iterations=LOOP_ITERS):
    """Phase 7: the host training loop through ``Trainer``, as a user
    trains; K1-K3 held against their plain versions on the last step's
    inputs. Returns the run's record (with the scene, which phase 11
    trains again, and the trainer, which phase 11 times beside its own),
    each kernel's max abs error on that step and K2's inputs there."""
    from grendel_tpu_torch.engine.trainer import Trainer
    from grendel_tpu_torch.testing import StructuredSyntheticScene

    t0 = time.perf_counter()
    scene = StructuredSyntheticScene(**scene_kw)
    print(f"# structured scene: {len(scene.train_cameras)} train / "
          f"{len(scene.test_cameras)} held-out views at {scene_kw['width']}x"
          f"{scene_kw['height']}, {scene.point_cloud.points.shape[0]} initial "
          f"points, raytraced in {time.perf_counter() - t0:.1f} s")
    # a checkpoint at the end too: phase 12's tools run on the trained model
    trainer = Trainer(loop_config(model_path, iterations,
                                  (LOOP_CHECKPOINT, iterations)),
                      scene, device=dev)
    calls = {}
    rec = train_loop(trainer, tag, kernels_of, iterations, "loop", calls)
    errs = loop_kernel_checks(calls)
    step_k2_in = calls["K2"][0]
    calls.clear()
    resume_check(trainer, dev, "loop")
    rec["scene"], rec["trainer"] = scene, trainer
    return rec, errs, step_k2_in


def dist_loop_path(dev, tag, kernels_of, ref, model_path,
                   iterations=LOOP_ITERS):
    """Phase 11: phase 7's run through the multi-rank loop
    (engine/trainer_dist.py ``MultiRankTrainer``, which drives
    ``DistributedTrainer``) on a one-rank NCCL group over a TCP store on
    127.0.0.1: K1-K3 in every step and held against their plain versions
    on the last step's inputs, step-0 L1 within 1e-5 relative of phase
    7's ``ref``, held-out PSNR rising and within 0.3 dB of phase 7's,
    n_alive within 2% of it (another code path, so the gate stays; the
    gap repeats from run to run), and the resume; then both loops timed in
    alternation. Returns the run's record and each kernel's max abs
    error."""
    import torch.distributed as dist

    from grendel_tpu_torch.engine.trainer_dist import MultiRankTrainer
    from grendel_tpu_torch.parallel import comm

    store = dist.TCPStore("127.0.0.1", free_port(), 1, True)
    comm.init_group(dev, rank=0, world_size=1, store=store)
    try:
        trainer = MultiRankTrainer(loop_config(model_path, iterations),
                                   ref["scene"], device=dev)
        require(not trainer.sharded, "phase 11 sharded the model at world "
                "size 1")
        calls = {}
        rec = train_loop(trainer, tag, kernels_of, iterations,
                         f"distributed loop ({dist.get_backend()}, world "
                         f"size 1)", calls)
        errs = loop_kernel_checks(calls)
        calls.clear()
        l1_rel = abs(rec["l1_0"] / ref["l1_0"] - 1.0)
        d_psnr = rec["psnr_after"] - ref["psnr_after"]
        d_alive = rec["n_alive"] / ref["n_alive"] - 1.0
        print(f"# distributed loop against phase 7: step-0 L1 relative err "
              f"{l1_rel:.3e}, held-out PSNR {rec['psnr_after']!r} vs "
              f"{ref['psnr_after']!r} dB ({d_psnr:+.6f}), alive "
              f"{rec['n_alive']} vs {ref['n_alive']} ({d_alive:+.2%}), "
              f"{rec['ips']:.2f} vs {ref['ips']:.2f} iterations/s, wall "
              f"{rec['wall_ms']:.3f} vs {ref['wall_ms']:.3f} ms per step "
              f"(host enqueue of the step {rec['enqueue_ms']:.3f} vs "
              f"{ref['enqueue_ms']:.3f} ms), device {rec['dev_ms']:.3f} vs "
              f"{ref['dev_ms']:.3f} ms per step, synchronizing calls per "
              f"step {rec['syncs']:.1f} vs {ref['syncs']:.1f}, launches per "
              f"step {rec['step_launches']} vs {ref['step_launches']}, peak "
              f"{rec['peak_gib']:.2f} vs {ref['peak_gib']:.2f} GiB {tag}")
        require(l1_rel <= 1e-5, f"distributed loop step-0 L1 "
                f"{rec['l1_0']} vs phase 7's {ref['l1_0']}")
        require(abs(d_psnr) <= 0.3, f"distributed loop held-out PSNR "
                f"{rec['psnr_after']} vs phase 7's {ref['psnr_after']}")
        require(abs(d_alive) <= 0.02, f"distributed loop alive "
                f"{rec['n_alive']} vs phase 7's {ref['n_alive']}")
        one, multi = alternating_walls(ref["trainer"], trainer, 15)
        rec["alternating"] = (one, multi)
        ratio = sum(one) / sum(multi)
        print(f"# one-device and distributed loops in alternation (one, "
              f"distributed, distributed, one; 15 steps each): "
              f"{one[0]:.3f}, {multi[0]:.3f}, {multi[1]:.3f}, {one[1]:.3f} ms "
              f"per step; iterations/s ratio {ratio:.3f}; device busy "
              f"{ref['dev_ms'] / statistics.mean(one):.1%} vs "
              f"{rec['dev_ms'] / statistics.mean(multi):.1%} {tag}")
        resume_check(trainer, dev, "distributed loop")
    finally:
        comm.destroy_group()
        del store
    return rec, errs


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


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def moments_rel_err(got, want, what):
    """Each Adam moment leaf of ``got`` within MOMENT_REL_TOL of the
    matching leaf's largest value in ``want``; returns the largest error."""
    err = 0.0
    for name, a, b in zip([f"mu.{k}" for k in want.params._fields]
                          + [f"nu.{k}" for k in want.params._fields],
                          got.adam.mu + got.adam.nu,
                          want.adam.mu + want.adam.nu):
        e = rel_err(a, b)
        require(e <= MOMENT_REL_TOL, f"{what}: Adam moment {name} err / max "
                f"{e:.3e} > {MOMENT_REL_TOL}")
        err = max(err, e)
    return err


def distributed_path(dev, tag, kernels_of, cameras, tr, steps=DIST_STEPS):
    """Phase 10: the distributed step (parallel/sharded.py).

    (a) DistributedTrainer on a one-rank process group (NCCL on the card,
    over a TCP store on 127.0.0.1) at the garden's full width, ``steps``
    steps in each distribution mode through the real all-to-all and
    all-reduce: K1, K2 and K3 launch in every step; step 1's loss equals
    train_step's within 1e-5 relative and its Adam moments within
    MOMENT_REL_TOL of each leaf's largest; one render equals render_batch
    within 1e-5. (b) The flat path of D > 1 ranks, simulated in one
    process (testing.simulate_distributed; NCCL takes one rank per GPU):
    D=2 split at the camera border, whose loss equals train_step's within
    1e-5 relative and its gradients within 1e-4 of each leaf's largest;
    D=4 on an uneven division, whose assembled render equals render_batch
    within 1e-5, and on whose flat tile lists K1 and K2 are held to their
    plain versions; K3 is held to its plain version on every scan of both
    simulations. Returns the printed numbers' record and each kernel's max
    abs error."""
    import torch.distributed as dist

    from grendel_tpu_torch.engine.render import render_batch
    from grendel_tpu_torch.parallel import comm
    from grendel_tpu_torch.parallel.division import divide_rows, pack_gt_rows
    from grendel_tpu_torch.parallel.sharded import (DistributedTrainer,
                                                    ParallelConfig)
    from grendel_tpu_torch.testing import simulate_distributed

    rcfg, bsz = tr.cfg, tr.bsz
    capacity = tr.state.alive.shape[0]
    gt_np = list(tr.gt_u8.cpu().numpy())
    one, one_m = tr.step(tr.state)
    # the step's gradient, from the first Adam moment of a fresh state:
    # mu = (1 - beta1) g / bsz
    g_one = [mu / (1.0 - tr.lrs.beta1) * bsz for mu in one.adam.mu]
    with torch.no_grad():
        imgs_one, _, _ = render_batch(tr.state.params, tr.state.alive,
                                      tr.cams, tr.sh_degree, rcfg, bg=tr.bg)
    loss_one = float(one_m["loss"])
    kw = dict(bsz=bsz, img_h=rcfg.img_h, img_w=rcfg.img_w,
              tile_w=rcfg.tile_w, tile_h=rcfg.tile_h,
              isect_capacity=bsz * rcfg.isect_capacity,
              blend_capacity=bsz * rcfg.blend_cap,
              max_per_tile=rcfg.max_per_tile)
    record = {}

    def gt_rows_of(pos, d_count, cfg):
        return torch.as_tensor(pack_gt_rows(
            cameras, pos, d_count, cfg.n_row_slots, cfg.tile_h, cfg.img_h,
            cfg.img_w, gt_override=gt_np), device=dev)

    # --- (a) the real collectives at world size 1 --------------------------
    store = dist.TCPStore("127.0.0.1", free_port(), 1, True)
    comm.init_group(dev, rank=0, world_size=1, store=store)
    try:
        for mode in ("sharded", "replicated"):
            cfg = ParallelConfig(
                n_devices=1, send_cap=bsz * capacity,
                gaussians_distribution=mode == "sharded", **kw
            ).resolved(capacity)
            dt = DistributedTrainer(cfg, tr.sh_degree, tr.lambda_dssim,
                                    tr.lrs, tr.xyz_sched)
            pos = torch.tensor([0, cfg.total_rows], dtype=torch.int32,
                               device=dev)
            gt_rows = gt_rows_of(pos.cpu().numpy(), 1, cfg)[0]
            state = dt.shard_state(tr.state)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            losses = []
            for i in range(steps):
                for wrapper in kernels_of.values():
                    wrapper.launches = 0
                state, m = dt.step(state, tr.cams, gt_rows, pos, tr.bg)
                torch.cuda.synchronize()
                n = {name: w.launches for name, w in kernels_of.items()}
                require(all(v > 0 for v in n.values()),
                        f"distributed step {i + 1} ({mode}): a kernel did "
                        f"not launch: {n}")
                require(int(m["a2a_overflow"].sum()) == 0
                        and int(m["num_isects"].max()) < cfg.isect_capacity,
                        f"distributed step {i + 1} ({mode}) overflowed: "
                        f"{m['telemetry'].tolist()}")
                losses.append(float(m["loss"]))
                print(f"# distributed step {i + 1} ({mode}, world size 1, "
                      f"{dist.get_backend()}): loss {losses[-1]:.6f} "
                      f"telemetry {m['telemetry'].tolist()} launches {n}")
                if i == 0:
                    loss_rel = abs(losses[0] / loss_one - 1.0)
                    mom_err = moments_rel_err(state, one, f"distributed "
                                              f"step 1 ({mode})")
                    require(loss_rel <= 1e-5, f"distributed step 1 ({mode}) "
                            f"loss {losses[0]} vs train_step {loss_one}")
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            require(all(torch.isfinite(p).all() for p in state.params),
                    f"non-finite parameter after the {mode} steps")
            imgs = dt.render(tr.state.params, tr.state.alive, tr.cams, pos,
                             tr.bg)
            render_err = float((imgs - imgs_one).abs().max())
            require(render_err <= 1e-5, f"distributed render ({mode}) "
                    f"differs from render_batch: {render_err}")
            print(f"# distributed ({mode}, world size 1): step 1 loss "
                  f"relative err vs train_step {loss_rel:.3e}, Adam moments "
                  f"err / max {mom_err:.3e}; render max abs err vs "
                  f"render_batch {render_err:.3e}; peak device memory "
                  f"{peak:.2f} GiB above the {base / 2**30:.2f} GiB held "
                  f"before {tag}")
            holder = [state]

            def one_step():
                holder[0], _ = dt.step(holder[0], tr.cams, gt_rows, pos,
                                       tr.bg)

            print(f"# distributed step profile ({mode}, world size 1):")
            dev_ms, rows = profile(one_step, 5)
            per_kernel = kernel_launches(rows)
            print(f"# distributed step ({mode}, world size 1) device time "
                  f"per step: {dev_ms:.3f} ms; launches per step "
                  f"{per_kernel}, {sum(r[1] for r in rows):.0f} in all {tag}")
            record[mode] = dict(loss_rel=loss_rel, mom_err=mom_err,
                                render_err=render_err, peak_gib=peak,
                                dev_ms=dev_ms, launches=per_kernel)

            def dist_steps(st):
                losses = []
                for _ in range(steps):
                    st, m = dt.step(st, tr.cams, gt_rows, pos, tr.bg)
                    losses.append(float(m["loss"]))
                return st, losses

            repeat_check(f"{steps} DistributedTrainer steps ({mode}, world "
                         f"size 1)", dist_steps, dt.shard_state(tr.state))
    finally:
        comm.destroy_group()
        del store

    # --- (b) the flat path of D > 1 ranks, simulated ------------------------
    tiles_y = ParallelConfig(n_devices=1, **kw).tiles_y
    heavy = np.ones(bsz * tiles_y)
    heavy[:tiles_y // 3] = 8.0             # camera 0's top rows cost more
    cases = {2: dict(n_row_slots=tiles_y, pos=[0, tiles_y, 2 * tiles_y]),
             4: dict(n_row_slots=2 * tiles_y, pos=None)}
    sim_err = {}
    for d_count, case in cases.items():
        cfg = ParallelConfig(
            n_devices=d_count, n_row_slots=case["n_row_slots"],
            send_cap=bsz * capacity // d_count, **kw
        ).resolved(capacity // d_count)
        pos_np = (divide_rows(heavy, d_count, cfg.n_row_slots)
                  if case["pos"] is None
                  else np.array(case["pos"], np.int32))
        pos = torch.as_tensor(pos_np, device=dev)
        gt_rows = gt_rows_of(pos_np, d_count, cfg)

        def sim():
            return simulate_distributed(
                tr.state.params, tr.state.alive, tr.cams, gt_rows, pos,
                tr.bg, cfg, tr.sh_degree, tr.lambda_dssim)

        calls = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for wrapper in kernels_of.values():
            wrapper.launches = 0
        with capture_kernel_inputs(calls):
            out = sim()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        n = {name: w.launches for name, w in kernels_of.items()}
        require(all(v > 0 for v in n.values()),
                f"simulated D={d_count}: a kernel did not launch: {n}")
        over = [int(a["a2a_overflow"]) for a in out.per_rank]
        isects = [int(a["num_isects"]) for a in out.per_rank]
        require(sum(over) == 0 and max(isects) < cfg.isect_capacity,
                f"simulated D={d_count} overflowed: {over}, {isects}")
        render_err = float((out.images - imgs_one).abs().max())
        loss_rel = abs(float(out.loss) / loss_one - 1.0)
        line = (f"# simulated D={d_count} (division {pos_np.tolist()}, "
                f"{cfg.n_row_slots} row slots, send_cap {cfg.send_cap}): "
                f"loss {float(out.loss):.6f} (train_step {loss_one:.6f}, "
                f"relative err {loss_rel:.3e}), render max abs err vs "
                f"render_batch {render_err:.3e}, demand "
                f"{[int(a['a2a_demand']) for a in out.per_rank]}, entries "
                f"{isects}, launches {n}")
        require(render_err <= 1e-5, f"simulated D={d_count} render differs "
                f"from render_batch: {render_err}")
        if d_count == 2:
            g_err = max(rel_err(a, b) for a, b in zip(out.grads, g_one))
            line += f", gradients err / max {g_err:.3e}"
            require(loss_rel <= 1e-5, f"simulated D=2 loss {float(out.loss)} "
                    f"vs train_step {loss_one}")
            require(g_err <= K2_REL_TOL, f"simulated D=2 gradients differ "
                    f"from train_step's: {g_err}")
        print(line)

        def sim_run(_):
            o = sim()
            return (o.grads, o.tap_grad, o.images), [float(o.loss)]

        repeat_check(f"simulated D={d_count} step", sim_run, None)
        # K3 on the flat row-span expansion's scans of every rank
        require(calls["K3"], f"captured no K3 call at D={d_count}")
        sim_err["K3"] = max(sim_err.get("K3", 0), scan_check(
            f"the simulated D={d_count} step's flat lists", calls["K3"]))
        print(f"# K3 scan (the simulated D={d_count} step): bit-equal to "
              f"plain in {len(calls['K3'])} calls")
        if d_count == 4:
            require(len(calls["K2"]) == d_count,
                    f"captured {len(calls['K2'])} K2 calls at D=4")
            sim_err["K1"], sim_err["K2"] = captured_blend_checks(
                "the simulated D=4 step's flat tile lists", calls["K2"])
        calls.clear()
        del out
        print(f"# simulated D={d_count} step profile (forward and backward "
              f"of every rank, no Adam):")
        dev_ms, rows = profile(sim, 3)
        record[f"D{d_count}"] = dict(loss_rel=loss_rel, render_err=render_err,
                                    peak_gib=peak, dev_ms=dev_ms,
                                    launches=kernel_launches(rows))
        print(f"# simulated D={d_count} device time per step {dev_ms:.3f} "
              f"ms, launches per step {record[f'D{d_count}']['launches']}, "
              f"{sum(r[1] for r in rows):.0f} in all; peak device memory "
              f"{peak:.2f} GiB above the {base / 2**30:.2f} GiB held before "
              f"{tag}")
    return record, sim_err


def random_lpips_weights(seed):
    """VGG16 LPIPS weights in ops/lpips.py's npz layout, random from a
    seed (no pretrained weights are in the repository)."""
    from grendel_tpu_torch.ops.lpips import _TAPS, _VGG16_PLAN

    rng = np.random.default_rng(seed)
    weights, in_ch = {}, 3
    for i, (out_ch, _) in enumerate(_VGG16_PLAN):
        weights[f"conv{i}_w"] = rng.normal(
            scale=0.05, size=(out_ch, in_ch, 3, 3)).astype(np.float32)
        weights[f"conv{i}_b"] = rng.normal(
            scale=0.01, size=(out_ch,)).astype(np.float32)
        in_ch = out_ch
    for j, i in enumerate(_TAPS):
        weights[f"lin{j}_w"] = rng.uniform(
            size=(_VGG16_PLAN[i][0],)).astype(np.float32)
    return weights


def tools_path(dev, tag, kernels_of, ref, model_path, step_dev_ms):
    """Phase 12: the tools on phase 7's trained model of the structured
    scene, as a user runs them after training: ``ckpt_to_ply`` of the
    iteration-300 checkpoint (the PLY's fields equal the checkpoint's);
    ``render.py`` over all 10 views through ``main(argv)`` (K1 and K3 in
    every batch and held against their plain versions on the first
    batch's inputs; each PNG within one level of ``render_batch``'s
    image); ``metrics.py`` on that tree (test PSNR within 0.02 dB of
    ``Trainer.eval_psnr`` on the model); LPIPS on random weights, the card
    within 1e-4 relative of the CPU; ``profile_step.py`` at the garden
    shape (every stage finite and positive, K1-K3 where they belong, and
    held against their plain versions on one ``full_step``'s and one
    ``isect``'s inputs); and a 30-iteration CLI run with ``--nsys_profile
    --log_memory_summary``. Returns the record, with each kernel's max
    abs error over these checks."""
    import dataclasses

    from grendel_tpu_torch.cameras import batch_camera_arrays
    from grendel_tpu_torch.engine import render as R
    from grendel_tpu_torch.engine.checkpoint import load_checkpoint_sharded
    from grendel_tpu_torch.engine.gaussian_io import (load_ply,
                                                      params_to_ply_fields)
    from grendel_tpu_torch.engine.trainer import Trainer
    from grendel_tpu_torch.ops.lpips import LPIPS
    from grendel_tpu_torch.scripts import (ckpt_to_ply, metrics,
                                           profile_step, render, train)
    from grendel_tpu_torch.utils.ply import read_ply
    from grendel_tpu_torch.utils.png import read_png

    rec = {}
    scene = ref["scene"]
    # the trained model: the loop's last checkpoint (the one of iteration
    # 200 follows an opacity reset, and its views are dark)
    ckpt = os.path.join(model_path, "checkpoints", str(LOOP_ITERS))
    # --- checkpoint to PLY
    ply = ckpt_to_ply.main(["-m", model_path])
    state = load_checkpoint_sharded(ckpt, 1, device="cpu")
    require(int(state.iteration) == LOOP_ITERS
            and ply.endswith(os.path.join(f"iteration_{LOOP_ITERS}",
                                          "point_cloud.ply")),
            f"ckpt_to_ply wrote {ply}")
    want = params_to_ply_fields(state.params, state.alive)
    got = read_ply(ply)
    require(list(got) == list(want) and all(
        np.array_equal(got[k], want[k]) for k in want),
        "ckpt_to_ply's PLY differs from the checkpoint")
    print(f"# ckpt_to_ply: {got['x'].shape[0]} Gaussians of iteration "
          f"{int(state.iteration)}, every field equal to the checkpoint's")

    # --- the render tool, in process, over every view
    with open(os.path.join(model_path, "args.json"), "w") as f:
        json.dump(dict(synthetic_structured=True, source_path="",
                       synthetic_size=f"{LOOP_SCENE['width']}x"
                                      f"{LOOP_SCENE['height']}",
                       synthetic_cams=LOOP_SCENE["n_cams"],
                       llffhold=LOOP_SCENE["llffhold"],
                       synthetic_points=LOOP_SCENE["n_init_points"],
                       seed=LOOP_SCENE["seed"], sh_degree=3,
                       white_background=False), f)
    real_render_batch = R.render_batch
    batches, calls = [], {}

    def counted(*args, **kw):
        for wrapper in kernels_of.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        if batches:
            out = real_render_batch(*args, **kw)
        else:                   # the first batch's kernel inputs are kept
            with capture_kernel_inputs(calls):
                out = real_render_batch(*args, **kw)
        torch.cuda.synchronize()
        batches.append((time.perf_counter() - t0,
                        {k: w.launches for k, w in kernels_of.items()}))
        return out

    R.render_batch = counted
    try:
        t0 = time.perf_counter()
        render.main(["-m", model_path, "--bsz", str(BSZ), "--device",
                     str(dev)])
        wall = time.perf_counter() - t0
    finally:
        R.render_batch = real_render_batch
    n_views = len(scene.train_cameras) + len(scene.test_cameras)
    require(len(batches) == -(-len(scene.train_cameras) // BSZ)
            + -(-len(scene.test_cameras) // BSZ),
            f"render tool ran {len(batches)} batches")
    require(all(n["K1"] > 0 and n["K3"] > 0 for _, n in batches),
            f"a render batch did not launch K1 and K3: {batches}")
    rec["render_ms_per_view"] = 1e3 * sum(t for t, _ in batches) / n_views
    rec["render_wall_ms_per_view"] = 1e3 * wall / n_views
    print(f"# render tool: {n_views} views at {LOOP_SCENE['width']}x"
          f"{LOOP_SCENE['height']} in {len(batches)} batches of {BSZ}, "
          f"launches per batch {[n for _, n in batches]}; "
          f"{rec['render_ms_per_view']:.3f} ms per view in render_batch "
          f"(synchronized), {rec['render_wall_ms_per_view']:.1f} ms per view "
          f"of the tool's wall (scene raytrace and PNG files included) {tag}")
    # K1 and K3 against their plain versions on the first batch's inputs:
    # 16x16 tiles at 1280x832 on the exact-size lists
    require(len(calls["K1"]) == 1 and calls["K3"] and not calls["K2"],
            f"captured {len(calls['K1'])} K1, {len(calls['K2'])} K2 and "
            f"{len(calls['K3'])} K3 calls in one render batch")
    errs = {"K1": captured_k1_checks("a render-tool batch", calls["K1"]),
            "K2": 0.0, "K3": scan_check("a render-tool batch", calls["K3"])}
    print(f"# K3 scan (a render-tool batch): bit-equal to plain in "
          f"{len(calls['K3'])} calls")
    calls.clear()
    # each PNG against render_batch's image of the view, static lists
    params, alive = load_ply(ply, device=dev)
    cfg = R.RenderConfig(img_h=LOOP_SCENE["height"], img_w=LOOP_SCENE["width"],
                         tile_w=16, tile_h=16, isect_capacity=1 << 22,
                         max_per_tile=2048)
    worst = 0
    for split, cams in (("train", scene.train_cameras),
                        ("test", scene.test_cameras)):
        d = os.path.join(model_path, split, f"ours_{LOOP_ITERS}",
                         "renders")
        for i, cam in enumerate(cams):
            with torch.no_grad():
                img = R.render_batch(params, alive, batch_camera_arrays(
                    [cam], dev), 3, cfg)[0][0]
            ref_u8 = (torch.clamp(img, 0, 1).cpu().numpy().transpose(1, 2, 0)
                      * 255 + 0.5).astype(np.uint8)
            png = read_png(os.path.join(d, f"{i:05d}.png"))
            worst = max(worst, int(np.abs(png.astype(int)
                                          - ref_u8.astype(int)).max()))
    print(f"# render tool PNGs against render_batch: largest difference "
          f"{worst} of 255")
    require(worst <= 1, f"a rendered PNG differs from render_batch by "
            f"{worst} levels")

    # --- the metrics tool with LPIPS, against the loop's eval
    wpath = os.path.join(model_path, "lpips_random.npz")
    weights = random_lpips_weights(0)
    np.savez(wpath, **weights)
    t0 = time.perf_counter()
    metrics.main(["-m", model_path, "--lpips_weights", wpath, "--device",
                  str(dev)])
    rec["metrics_s"] = time.perf_counter() - t0
    with open(os.path.join(model_path, "results_test.json")) as f:
        res = json.load(f)[f"ours_{LOOP_ITERS}"]
    cfg_ev = dataclasses.replace(ref["trainer"].cfg, start_checkpoint=ckpt,
                                 checkpoint_iterations=[])
    evaluator = Trainer(cfg_ev, scene, device=dev)
    ev = evaluator.eval_psnr(scene.test_cameras, 3)
    d_psnr = res["PSNR"] - ev["psnr"]
    rec["psnr"], rec["eval_psnr"] = res["PSNR"], ev["psnr"]
    print(f"# metrics tool, test split: PSNR {res['PSNR']:.4f} dB against "
          f"eval_psnr {ev['psnr']:.4f} dB ({d_psnr:+.4f}), SSIM "
          f"{res['SSIM']:.4f}, LPIPS (random weights) {res['LPIPS']:.6f}; "
          f"{rec['metrics_s']:.2f} s for {n_views} views")
    require(abs(d_psnr) <= 0.02, f"metrics PSNR {res['PSNR']} vs eval_psnr "
            f"{ev['psnr']}")
    require(res["LPIPS"] is not None and np.isfinite(res["LPIPS"]),
            f"metrics LPIPS {res['LPIPS']}")
    # LPIPS on the card (TF32 allowed globally: the module turns it off)
    # against the CPU on one pair, the central 320x208 crop of view 0
    d = os.path.join(model_path, "test", f"ours_{LOOP_ITERS}")
    y0 = (LOOP_SCENE["height"] - 208) // 2
    x0 = (LOOP_SCENE["width"] - 320) // 2
    pair = [torch.as_tensor(read_png(os.path.join(d, sub, "00000.png"))
                            [y0:y0 + 208, x0:x0 + 320].transpose(2, 0, 1)
                            .astype(np.float32) / 255.0)
            for sub in ("renders", "gt")]
    torch.backends.cudnn.allow_tf32 = True
    try:
        on_card = float(LPIPS(weights, device=dev)(*(x.to(dev)
                                                     for x in pair)))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    on_cpu = float(LPIPS(weights, device="cpu")(*pair))
    require(on_cpu > 0, "the LPIPS pair is two equal images")
    lp_rel = abs(on_card / on_cpu - 1.0)
    print(f"# LPIPS card {on_card:.8f} vs CPU {on_cpu:.8f}: relative err "
          f"{lp_rel:.3e}")
    require(lp_rel <= 1e-4, f"LPIPS card vs CPU relative err {lp_rel}")

    # --- the step profiler at the garden shape
    prof_dir = os.path.join(model_path, "profile_trace")
    prof = profile_step.main([
        "--height", str(TOOLS_PROFILE["height"]), "--width",
        str(TOOLS_PROFILE["width"]), "--n", str(TOOLS_PROFILE["n"]), "--bsz",
        str(BSZ), "--steps", "10", "--trace", prof_dir, "--device",
        str(dev)])
    times, launches = prof["times"], prof["launches"]
    rec["profile"] = times
    print(f"# profile_step: full_step {times['full_step']:.3f} ms (CUDA "
          f"events), stage sum {prof['stage_sum']:.3f} ms "
          f"({prof['stage_sum'] / times['full_step']:.1%} of it); phase 9's "
          f"train_step device time {step_dev_ms:.3f} ms {tag}")
    require(all(np.isfinite(v) and v > 0 for v in times.values()),
            f"a profile stage is not finite and positive: {times}")
    for stage, need in (("full_step", "K1 K2 K2s K3"), ("isect", "K3"),
                        ("raster_fwd", "K1"),
                        ("raster_fwd_bwd", "K1 K2 K2s"),
                        ("render_batch_fwd", "K1 K3")):
        require(all(launches[stage][k] > 0 for k in need.split()),
                f"profile stage {stage} did not launch {need}: "
                f"{launches[stage]}")
    require(os.path.exists(os.path.join(prof_dir, "trace_rk0.json")),
            "profile_step wrote no trace")
    # K1-K3 against their plain versions on one full_step's inputs and K3
    # on one isect call's, at the garden shape with 32x16 tiles
    with capture_kernel_inputs(calls):
        prof["stages"]["full_step"]()
    step_errs = loop_kernel_checks(calls, "a profile_step full_step")
    with capture_kernel_inputs(calls):
        prof["stages"]["isect"]()
    require(calls["K3"] and not calls["K1"] and not calls["K2"],
            f"captured {len(calls['K3'])} K3 calls in one isect stage")
    step_errs["K3"] = max(step_errs["K3"],
                          scan_check("a profile_step isect", calls["K3"]))
    print(f"# K3 scan (a profile_step isect): bit-equal to plain in "
          f"{len(calls['K3'])} calls")
    calls.clear()
    del prof["stages"]
    rec["errs"] = {k: max(e, step_errs[k]) for k, e in errs.items()}

    # --- a short CLI run with the profiler trace and the memory lines
    run = os.path.join(model_path, "cli")
    t0 = time.perf_counter()
    train.main(["--synthetic_structured", "--synthetic_size", TOOLS_CLI_SIZE,
                "--synthetic_cams", "10", "--llffhold", "5",
                "--synthetic_points", "20000", "--iterations", "30",
                "--bsz", str(BSZ), "--densify_from_iter", "1000",
                "--test_iterations", "30", "--save_iterations", "30",
                "--nsys_profile", "--log_memory_summary", "--log_interval",
                "10", "--device", str(dev), "-q", "-m", run])
    rec["cli_s"] = time.perf_counter() - t0
    with open(os.path.join(run, "trace", "trace_rk0.json")) as f:
        trace_text = f.read()
    with open(os.path.join(run, "python_ws=1_rk=0.log")) as f:
        mem = [ln for ln in f if ": memory compiled_reserved=" in ln]
    print(f"# CLI run, 30 iterations at {TOOLS_CLI_SIZE} with --nsys_profile "
          f"--log_memory_summary: {rec['cli_s']:.1f} s; trace "
          f"{len(trace_text) / 2**20:.1f} MiB names K1: "
          f"{'rasterize_fwd' in trace_text}; memory lines "
          f"{[ln.split('] ')[1].strip() for ln in mem]}")
    require("rasterize_fwd" in trace_text, "the CLI's trace names no K1")
    require(len(mem) == 3, f"{len(mem)} memory lines in 30 iterations")
    return rec


def fourk_path(dev, tag, kernels_of, timer, model_path, size=FOURK_SIZE,
               points=FOURK_POINTS, cams=FOURK_CAMS, llffhold=FOURK_HOLD,
               iterations=FOURK_ITERS, dist_iters=FOURK_DIST_ITERS):
    """Phase 13: examples/structured_4k.sh's configuration through the
    port's training CLI (``scripts/train.py main``) as a user runs it, its
    views cut to ``cams``: K1-K3 in every step and held against their
    plain versions on the last step's inputs, finite losses and
    parameters, a densify round that clones or splits, held-out PSNR
    rising, the entry ceiling read from the card above 2^22 and no step
    over capacity at it; then the memory, time and kernel numbers of the
    run, the bytes a step takes per entry of capacity, and the same scene
    through ``MultiRankTrainer`` (``fourk_dist``). Returns the record and
    each kernel's max abs error."""
    from grendel_tpu_torch.engine import trainer_dist
    from grendel_tpu_torch.engine.trainer import ISECT_CAP_CEILING
    from grendel_tpu_torch.scripts import train
    from grendel_tpu_torch.utils import hbm

    t_phase = time.perf_counter()
    if iterations < FOURK_ITERS:
        print(f"# reduced: iterations {FOURK_ITERS} -> {iterations}: the "
              f"phase's time")
    run = {"losses": [], "entries": []}
    totals = {name: 0 for name in kernels_of}
    calls = {}
    real_make = trainer_dist.make_trainer

    def make(*args, **kw):
        tr = real_make(*args, **kw)
        run["setup_s"] = time.perf_counter() - t0
        sc = tr.scene
        print(f"# reduced: views 12 -> "
              f"{len(sc.train_cameras) + len(sc.test_cameras)} "
              f"({len(sc.train_cameras)} training, {len(sc.test_cameras)} "
              f"held out; --synthetic_cams {cams}): the host raytrace of "
              f"the ground truth, {run['setup_s']:.1f} s for these with "
              f"the scene's set-up")
        run["psnr_before"] = tr.eval_psnr(tr.scene.test_cameras, 0)
        run["trainer"], run["real_step"] = tr, tr._step

        def step(*a):
            for wrapper in kernels_of.values():
                wrapper.launches = 0
            if len(run["losses"]) == iterations - 1:
                with capture_kernel_inputs(calls):
                    state, m = run["real_step"](*a)
            else:
                state, m = run["real_step"](*a)
            n = {name: w.launches for name, w in kernels_of.items()}
            require(all(v > 0 for v in n.values()),
                    f"4K step {len(run['losses']) + 1}: a kernel did not "
                    f"launch: {n}")
            for name in totals:
                totals[name] += n[name]
            run["losses"].append(m["loss"])
            run["entries"].append(m["num_isects"][0])
            return state, m

        tr._step = step
        return tr

    trainer_dist.make_trainer = make
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        train.main(["--synthetic_structured", "--synthetic_size", size,
                    "--synthetic_cams", str(cams), "--llffhold", str(llffhold),
                    "--synthetic_points", str(points), "--iterations",
                    str(iterations), "--bsz", "1", "--seed", "4",
                    "--densify_from_iter", "100", "--densification_interval",
                    "100", "--densify_until_iter", str(iterations),
                    "--test_iterations", str(iterations),
                    "--check_gpu_memory", "--log_memory_summary",
                    "--log_interval", "50", "--device", str(dev), "-q",
                    "-m", model_path])
    finally:
        trainer_dist.make_trainer = real_make
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    tr = run["trainer"]
    tr._step, tr.log = run["real_step"], None    # the CLI closed its log
    # the loop's own peak, before the plain versions below allocate theirs
    peak, reserved = tr.peak_memory()
    losses = torch.stack(run["losses"]).cpu()
    entries = torch.stack(run["entries"]).cpu()
    require(len(losses) == iterations
            and int(tr.state.iteration) == iterations,
            f"the 4K run ran {len(losses)} steps to iteration "
            f"{int(tr.state.iteration)}")
    require(bool(torch.isfinite(losses).all()), "non-finite 4K loss")
    require(all(bool(torch.isfinite(p).all()) for p in tr.state.params),
            "non-finite parameter after the 4K run")
    errs = loop_kernel_checks(calls, "a 4K loop step")
    k2_in, k3_in = calls["K2"][0], calls["K3"]
    calls.clear()
    with open(os.path.join(model_path, "python_ws=1_rk=0.log")) as f:
        log = f.read()
    ceilings = [int(ln.rsplit("-> ", 1)[1]) for ln in log.splitlines()
                if "isect entry ceiling -> " in ln]
    for r in tr.densify_history:
        print(f"# 4K densify: {r}")
    print(f"# 4K run, {iterations} iterations at {size}: launches {totals}; "
          f"loss {float(losses[0]):.5f} -> {float(losses[-1]):.5f}; "
          f"capacity events {tr.capacity_events}; ceiling readings "
          f"(entry capacity, step bytes, ceiling) {tr.hbm_readings}")
    require(ceilings and tr.isect_capacity_ceiling > ISECT_CAP_CEILING,
            f"4K run: entry ceiling {tr.isect_capacity_ceiling}, logged "
            f"{ceilings}")
    require("at the HBM ceiling" not in log, "a 4K step overflowed at the "
            "entry ceiling")
    require(any(r["clone"] + r["split"] > 0 for r in tr.densify_history),
            f"4K run: no densify round cloned or split: "
            f"{tr.densify_history}")
    psnr_after = tr.eval_psnr(tr.scene.test_cameras, 0)
    before = run["psnr_before"]
    print(f"# 4K held-out PSNR {before['psnr']:.3f} -> "
          f"{psnr_after['psnr']:.3f} dB, L1 {before['l1']:.5f} -> "
          f"{psnr_after['l1']:.5f} ({psnr_after['n']} views)")
    require(psnr_after["psnr"] > before["psnr"], "4K run: held-out PSNR "
            f"did not rise: {before} -> {psnr_after}")

    total = torch.cuda.get_device_properties(dev).total_memory
    step_bytes = tr.hbm_readings[-1][1]
    guard = "densification stopped" in log
    rec = dict(ips=iterations / tr.end2end.total_seconds(), cli_s=cli_s,
               setup_s=run["setup_s"], peak_entries=int(entries.max()),
               ceiling=tr.isect_capacity_ceiling, step_bytes=step_bytes,
               peak=peak, guard=guard)
    print(f"# 4K memory: entries a camera {int(entries[0])} at step 1, "
          f"{rec['peak_entries']} at the peak "
          f"(entry capacity {tr._isect_cap()}) against the ceiling "
          f"{rec['ceiling']} ({rec['ceiling'] / ISECT_CAP_CEILING:.1f}x "
          f"2^22; the int32 clamp {hbm.ENTRY_CAP_MAX}); the last measured "
          f"step took {step_bytes / 2**30:.2f} GiB "
          f"({step_bytes / total:.1%} of the card's {total / 2**30:.2f} "
          f"GiB); the run's peak {peak / 2**30:.2f} GiB allocated "
          f"({peak / total:.1%}; {base / 2**30:.2f} GiB held before the "
          f"phase), {reserved / 2**30:.2f} GiB reserved; memory guard "
          f"tripped: {guard}; memory lines "
          f"{[ln.split('] ')[1] for ln in log.splitlines() if ': memory ' in ln]}"
          f" {tag}")
    print(f"# 4K run: {rec['ips']:.2f} iterations/s over "
          f"{tr.end2end.total_seconds():.2f} s of training; scene set-up "
          f"(raytrace) {rec['setup_s']:.1f} s, CLI {cli_s:.1f} s {tag}")
    print("# 4K step profile:")
    rec["dev_ms"], rows = profile(
        lambda: tr.train(int(tr.state.iteration) + 1), 3)
    rec["launches"] = kernel_launches(rows)
    print(f"# 4K step device time {rec['dev_ms']:.3f} ms, launches per step "
          f"{rec['launches']}, {sum(r[1] for r in rows):.0f} in all {tag}")
    rec["bytes_per_entry"] = entry_bytes(tr, tag)
    rec["bytes_per_entry"]["flat"] = flat_entry_bytes(tr, tag)
    rec["kernels"] = step_kernel_times(timer, tag, k2_in, "the 4K step",
                                       chunk=16)
    for xs in k3_in:
        c, m_len = len(xs), xs[0].shape[0]
        k3_ms = timer.ms(lambda: kernels_of["K3"](xs), 20)
        print(f"# K3 on the 4K step, C={c} M={m_len}: {k3_ms:.4f} ms, bound "
              f"{1e3 * 2 * c * m_len * 4 / HBM_BYTES_PER_S:.4f} ms (bytes) "
              f"{tag}")
    del k2_in, k3_in
    rec["dist"] = fourk_dist(dev, tag, kernels_of, tr.scene, tr.cfg,
                             dist_iters, os.path.join(model_path, "dist"))
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"# 4K phase: {rec['phase_s']:.1f} s in all, raytrace and set-up "
          f"{rec['setup_s']:.1f} s {tag}")
    return rec, errs


def entry_bytes(tr, tag):
    """The bytes one 4K step takes per entry of capacity: its peak at the
    run's own entry capacity and twice it, and at FOURK_ENTRY_PROBE (2^27)
    entries and twice that, where the tile lists set the peak; returns the
    slopes of both pairs (the second is the device bytes per entry that
    ``BYTES_PER_ISECT_ENTRY`` holds, and must be within 5% of it)."""
    from grendel_tpu_torch.utils import hbm

    ids = torch.zeros(1, dtype=torch.long, device=tr.device)
    cams = type(tr._cam_bank)(*(x[ids] for x in tr._cam_bank))
    own = tr._isect_cap()
    big = max(FOURK_ENTRY_PROBE, 4 * own)
    peaks = {}
    saved = tr._isect_cap_current
    try:
        for cap in (own, 2 * own, big, 2 * big):
            tr._isect_cap_current = cap
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = tr._step(cams, tr._gt_bank[ids], tr.bg, 0)
            torch.cuda.synchronize()
            peaks[cap] = torch.cuda.max_memory_allocated()
            del out
    finally:
        tr._isect_cap_current = saved
    low = (peaks[2 * own] - peaks[own]) / own
    high = (peaks[2 * big] - peaks[big]) / big
    print(f"# bytes a 4K step takes per entry of capacity: step peak "
          f"{ {c: round(p / 2**30, 3) for c, p in peaks.items()} } GiB at "
          f"those capacities; {low:.2f} bytes an entry from {own} to "
          f"{2 * own}, {high:.2f} from {big} to {2 * big} (camera-blocked "
          f"lists; utils/hbm.py BYTES_PER_ISECT_ENTRY "
          f"{hbm.BYTES_PER_ISECT_ENTRY}) {tag}")
    require(abs(hbm.BYTES_PER_ISECT_ENTRY / high - 1.0) <= 0.05,
            f"BYTES_PER_ISECT_ENTRY {hbm.BYTES_PER_ISECT_ENTRY} is more "
            f"than 5% from the measured {high:.2f}")
    return {"own": low, "tile_lists": high}


def flat_entry_bytes(tr, tag, d_count=2):
    """The bytes one rank's step takes per entry of its capacity on the
    flat row-span lists (ops/isect.py isect_tile_rows, the lists of a rank
    at D > 1): a simulated D=2 step (testing.simulate_distributed, the
    rows split in half) of the trained 4K model on its first training
    view, its peak at FOURK_ENTRY_PROBE (2^27) entries a rank and twice
    that, where the lists set the peak. The simulation holds both ranks'
    graphs, so rank 0's saved entry ids (4 bytes an entry) are live while
    rank 1 builds its lists: the slope is a rank's own and those 4 bytes.
    Returns the slope, which the multi-rank loop's constant at D > 1
    (utils/hbm.py ``BYTES_PER_FLAT_ENTRY``) must be within 5% of."""
    from grendel_tpu_torch.cameras import batch_camera_arrays
    from grendel_tpu_torch.parallel.division import pack_gt_rows
    from grendel_tpu_torch.parallel.sharded import ParallelConfig
    from grendel_tpu_torch.testing import simulate_distributed
    from grendel_tpu_torch.utils import hbm

    rcfg = tr.render_config()
    cam = tr.scene.train_cameras[0]
    n = tr.state.alive.shape[0]
    base = ParallelConfig(n_devices=d_count, bsz=1, img_h=rcfg.img_h,
                          img_w=rcfg.img_w, tile_w=rcfg.tile_w,
                          tile_h=rcfg.tile_h, max_per_tile=rcfg.max_per_tile)
    pos_np = np.array([0, base.tiles_y // 2, base.tiles_y], np.int32)
    pos = torch.as_tensor(pos_np, device=tr.device)
    cams = batch_camera_arrays([cam], tr.device)
    peaks, rows = {}, None
    for cap in (FOURK_ENTRY_PROBE, 2 * FOURK_ENTRY_PROBE):
        cfg = base._replace(isect_capacity=cap).resolved(n // d_count)
        if rows is None:
            rows = torch.as_tensor(pack_gt_rows(
                [cam], pos_np, d_count, cfg.n_row_slots, cfg.tile_h,
                cfg.img_h, cfg.img_w), device=tr.device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = simulate_distributed(tr.state.params, tr.state.alive, cams,
                                   rows, pos, tr.bg, cfg, 0,
                                   tr.cfg.opt.lambda_dssim)
        torch.cuda.synchronize()
        peaks[cap] = torch.cuda.max_memory_allocated()
        require(bool(torch.isfinite(out.loss)), "non-finite loss of the "
                "simulated 4K step")
        del out
    slope = (peaks[2 * FOURK_ENTRY_PROBE]
             - peaks[FOURK_ENTRY_PROBE]) / FOURK_ENTRY_PROBE
    const = hbm.BYTES_PER_FLAT_ENTRY
    print(f"# bytes a rank's 4K step takes per entry of capacity, flat "
          f"row-span lists (simulated D={d_count}, rows split at "
          f"{pos_np.tolist()}): step peak "
          f"{ {c: round(p / 2**30, 3) for c, p in peaks.items()} } GiB; "
          f"{slope:.2f} bytes an entry from {FOURK_ENTRY_PROBE} to "
          f"{2 * FOURK_ENTRY_PROBE} (utils/hbm.py BYTES_PER_FLAT_ENTRY "
          f"{const}) {tag}")
    require(abs(const / slope - 1.0) <= 0.05, f"the multi-rank loop's "
            f"bytes per entry {const} is more than 5% from the measured "
            f"{slope:.2f}")
    return slope


def fourk_dist(dev, tag, kernels_of, scene, cfg, iterations, model_path):
    """The 4K scene through ``MultiRankTrainer`` on a one-rank NCCL group
    for ``iterations``: K1-K3 in every step, its entry ceiling read from
    the card above 2^22 and no step over capacity at it. Returns its
    entries a rank and its ceiling."""
    import dataclasses
    import io

    import torch.distributed as dist

    from grendel_tpu_torch.engine.trainer import ISECT_CAP_CEILING
    from grendel_tpu_torch.engine.trainer_dist import MultiRankTrainer
    from grendel_tpu_torch.parallel import comm
    from grendel_tpu_torch.utils import hbm

    cfg = dataclasses.replace(
        cfg, test_iterations=[], save_iterations=[], checkpoint_iterations=[],
        model=dataclasses.replace(cfg.model, model_path=model_path),
        opt=dataclasses.replace(cfg.opt, iterations=iterations))
    log = io.StringIO()
    entries = []
    totals = {name: 0 for name in kernels_of}
    store = dist.TCPStore("127.0.0.1", free_port(), 1, True)
    comm.init_group(dev, rank=0, world_size=1, store=store)
    try:
        mt = MultiRankTrainer(cfg, scene, device=dev, log_file=log)
        real_step = mt._step

        def step(*a):
            for wrapper in kernels_of.values():
                wrapper.launches = 0
            state, m = real_step(*a)
            n = {name: w.launches for name, w in kernels_of.items()}
            require(all(v > 0 for v in n.values()), f"4K distributed step "
                    f"{len(entries) + 1}: a kernel did not launch: {n}")
            for name in totals:
                totals[name] += n[name]
            entries.append(m["num_isects"].max())
            return state, m

        mt._step = step
        t0 = time.perf_counter()
        mt.train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        comm.destroy_group()
        del store
    text = log.getvalue()
    top = int(torch.stack(entries).max())
    print(f"# 4K distributed loop ({iterations} iterations, world size 1, "
          f"nccl): entries a rank up to {top} against its ceiling "
          f"{mt.isect_capacity_ceiling} (the int32 clamp "
          f"{hbm.ENTRY_CAP_MAX}; readings {mt.hbm_readings}); "
          f"capacity events {mt.capacity_events}; launches {totals}; "
          f"{secs:.1f} s {tag}")
    require(len(entries) == iterations, f"the 4K distributed loop ran "
            f"{len(entries)} steps")
    require(mt.isect_capacity_ceiling > ISECT_CAP_CEILING
            and "isect entry ceiling -> " in text,
            f"4K distributed loop: entry ceiling {mt.isect_capacity_ceiling}")
    require("at the HBM ceiling" not in text, "a 4K distributed step "
            "overflowed at the entry ceiling")
    return {"entries": top, "ceiling": mt.isect_capacity_ceiling}


def paeth_strip_png(path, img, rows):
    """Write the first ``rows`` rows of ``img`` (H, W, 3) uint8 as a PNG
    whose every row carries the Paeth filter (4), the filter that
    ``read_png`` undoes a pixel at a time, as PIL's writer often picks."""
    import struct
    import zlib

    x = img[:rows].astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]                      # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                            # above
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]                   # above left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    filt = ((x - pred) & 0xFF).astype(np.uint8).reshape(rows, -1)
    raw = np.concatenate([np.full((rows, 1), 4, np.uint8), filt], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], rows,
                                           8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes())))
        f.write(chunk(b"IEND", b""))


def storage_cli_run(dev, kernels_of, argv, what, calls=None):
    """Train through the CLI's ``main(argv)`` as a user does, wrapping
    ``trainer_dist.make_trainer`` to hook the loop: launch counts zeroed
    just before each step and read just after (every step must launch
    every kernel), each step's L1, the host's time in the loop's
    ground-truth stage (``_batch_gt``), and with ``calls`` the last step's
    kernel inputs. Returns the run's record with its trainer."""
    import gc

    from grendel_tpu_torch.engine import trainer_dist
    from grendel_tpu_torch.scripts import train

    iterations = int(argv[argv.index("--iterations") + 1])
    n_steps = iterations // BSZ
    run = {"l1": [], "gt_ms": [], "launches": {k: 0 for k in kernels_of}}
    real_make = trainer_dist.make_trainer

    def make(*args, **kw):
        tr = real_make(*args, **kw)
        run["psnr_before"] = tr.eval_psnr(tr.scene.test_cameras, 0)
        run["trainer"] = tr
        real_step, real_gt = tr._step, tr._batch_gt

        def step(*a):
            for wrapper in kernels_of.values():
                wrapper.launches = 0
            if calls is not None and len(run["l1"]) == n_steps - 1:
                with capture_kernel_inputs(calls):
                    state, m = real_step(*a)
            else:
                state, m = real_step(*a)
            n = {name: w.launches for name, w in kernels_of.items()}
            require(all(v > 0 for v in n.values()),
                    f"{what} step {len(run['l1']) + 1}: a kernel did not "
                    f"launch: {n}")
            for name in n:
                run["launches"][name] += n[name]
            run["l1"].append(m["l1"].sum())
            return state, m

        def batch_gt(*a):
            t0 = time.perf_counter()
            out = real_gt(*a)
            run["gt_ms"].append((time.perf_counter() - t0) * 1e3)
            return out

        tr._step, tr._batch_gt = step, batch_gt
        run["real"] = real_step, real_gt
        return tr

    trainer_dist.make_trainer = make
    # earlier phases' garbage freed first, or the base counts it and a
    # collection during the run hides part of the run's peak
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        train.main(argv)
    finally:
        trainer_dist.make_trainer = real_make
    torch.cuda.synchronize()
    tr = run["trainer"]
    tr._step, tr._batch_gt = run.pop("real")
    tr.log = None                          # the CLI closed its log
    run["peak_gib"] = (tr.peak_memory()[0] - base) / 2**30
    run["ips"] = iterations / tr.end2end.total_seconds()
    require(len(run["l1"]) == n_steps, f"{what} ran {len(run['l1'])} steps")
    run["l1"] = torch.stack(run["l1"]).cpu()
    require(bool(torch.isfinite(run["l1"]).all()), f"non-finite {what} L1")
    pairs = tr.timer._pairs.get("20 ground truth", [])
    run["gt_timer_ms"] = tr.timer.elapsed_ms("20 ground truth") / max(
        len(pairs), 1)
    run["gt_host_ms"] = statistics.median(run["gt_ms"])
    run["psnr_after"] = tr.eval_psnr(tr.scene.test_cameras, 0)
    run["n_alive"] = tr._n_alive()
    sites = sync_sites(
        lambda: tr.train(int(tr.state.iteration) + 5 * BSZ))
    run["syncs"] = sum(sites.values()) / 5
    print(f"# {what}: {iterations} iterations at {run['ips']:.2f} "
          f"iterations/s; step-0 L1 {float(run['l1'][0]):.7f}; held-out "
          f"PSNR {run['psnr_before']['psnr']:.3f} -> "
          f"{run['psnr_after']['psnr']:.3f} dB; ground truth per step: "
          f"{run['gt_host_ms']:.3f} ms of host (median), "
          f"{run['gt_timer_ms']:.3f} ms on the loop's timer (CUDA events "
          f"around the stage); peak {run['peak_gib']:.3f} GiB above what "
          f"the process held; {run['syncs']:.1f} synchronizing calls per "
          f"step, by site {dict(sites)}; bank on the device: "
          f"{tr._gt_bank is not None}; launches {run['launches']}; "
          f"capacity events {tr.capacity_events}; densify "
          f"{tr.densify_history}; ceiling readings {tr.hbm_readings}")
    return run


def storage_path(dev, tag, kernels_of, scene, tmp,
                 iterations=LOOP_ITERS, lazy_iters=STORAGE_LAZY_ITERS,
                 mem_views=STORAGE_MEM_VIEWS, mem_size=STORAGE_MEM_SIZE,
                 mem_iters=STORAGE_MEM_ITERS):
    """Phase 14: host-resident ground truth. (a) phase 7's views written
    as a COLMAP + PNG dataset and trained through the CLI, preloaded and
    at threshold 0 (host path); (b) the dataset through
    ``MultiRankTrainer`` on a one-rank NCCL group with every camera lazy
    and the decode cache at 3 views; (c) the one-device loop's peak memory
    at few and many views, with and without the preload. Returns the
    record and each kernel's max abs error (K1-K3 held to plain on the
    host run's last step)."""
    from grendel_tpu_torch.scripts.export_structured_dataset import \
        write_dataset
    from grendel_tpu_torch.utils.png import read_png

    t_phase = time.perf_counter()
    data = os.path.join(tmp, "dataset")
    t0 = time.perf_counter()
    views = sorted(scene.train_cameras + scene.test_cameras,
                   key=lambda c: c.uid)
    write_dataset(data, views, scene.point_cloud)
    print(f"# storage (phase 14): phase 7's {len(views)} views written as a "
          f"COLMAP + PNG dataset in {time.perf_counter() - t0:.2f} s")

    # --- (a) the on-disk path through the CLI, both ground-truth paths
    argv = ["-s", data, "--eval", "--llffhold", str(LOOP_SCENE["llffhold"]),
            "--iterations", str(iterations), "--bsz", str(BSZ),
            "--densify_from_iter", "100", "--densification_interval", "100",
            "--densify_until_iter", str(iterations),
            "--opacity_reset_interval", "200", "--log_interval", "100000",
            "--enable_timer", "--device", str(dev), "-q"]
    calls = {}
    pre = storage_cli_run(dev, kernels_of, argv + [
        "-m", os.path.join(tmp, "pre")], "preloaded run (a)")
    host = storage_cli_run(dev, kernels_of, argv + [
        "-m", os.path.join(tmp, "host"), "--preload_dataset_to_gpu_threshold",
        "0"], "host-path run (a)", calls)
    errs = loop_kernel_checks(calls, "a host-path loop step")
    calls.clear()
    l1_rel = abs(float(host["l1"][0]) / float(pre["l1"][0]) - 1.0)
    d_psnr = host["psnr_after"]["psnr"] - pre["psnr_after"]["psnr"]
    require(pre["trainer"]._gt_bank is not None, "the preloaded run has no "
            "bank")
    require(host["trainer"]._gt_bank is None, "the host-path run built a "
            "ground-truth bank on the device")
    require(l1_rel <= 1e-6, f"step-0 L1 of the host path "
            f"{float(host['l1'][0])} vs the preloaded {float(pre['l1'][0])}")
    for r, name in ((pre, "preloaded"), (host, "host-path")):
        require(r["psnr_after"]["psnr"] > r["psnr_before"]["psnr"],
                f"{name} run: held-out PSNR did not rise")
    # the two paths run the same arithmetic on the same bytes, and like
    # runs repeat bit for bit: every step's L1, the held-out PSNR and the
    # alive count must be equal
    same_l1 = torch.equal(host["l1"], pre["l1"])
    print(f"# (a) host path against preloaded, {len(pre['l1'])} steps: L1 "
          f"of every step equal: {same_l1}; held-out PSNR "
          f"{host['psnr_after']['psnr']!r} vs {pre['psnr_after']['psnr']!r} "
          f"dB; alive {host['n_alive']} vs {pre['n_alive']}")
    require(same_l1 and d_psnr == 0.0 and host["n_alive"] == pre["n_alive"],
            f"the host path differs from the preloaded: L1 equal {same_l1}, "
            f"PSNR {d_psnr:+.6f} dB, alive {host['n_alive']} vs "
            f"{pre['n_alive']}")
    one, other = alternating_walls(pre["trainer"], host["trainer"], 15)
    ratio = sum(one) / sum(other)
    print(f"# (a) host path against preloaded: step-0 L1 relative err "
          f"{l1_rel:.3e}, held-out PSNR {host['psnr_after']['psnr']:.3f} vs "
          f"{pre['psnr_after']['psnr']:.3f} dB ({d_psnr:+.3f}); "
          f"{host['ips']:.2f} vs {pre['ips']:.2f} iterations/s; in "
          f"alternation (preloaded, host, host, preloaded; 15 steps each) "
          f"{one[0]:.3f}, {other[0]:.3f}, {other[1]:.3f}, {one[1]:.3f} ms "
          f"per step, iterations/s ratio host / preloaded {ratio:.3f} {tag}")

    # --- (b) every camera lazy, the decode cache at 3 views, one rank
    view_bytes = views[0].gt().nbytes
    t0 = time.perf_counter()
    for _ in range(5):
        read_png(os.path.join(data, "images", f"{views[0].image_name}.png"))
    png_ms = (time.perf_counter() - t0) * 1e3 / 5
    strip = os.path.join(tmp, "paeth.png")
    paeth_rows = min(104, views[0].height)
    paeth_strip_png(strip, views[0].gt().transpose(1, 2, 0), paeth_rows)
    t0 = time.perf_counter()
    back = read_png(strip)
    paeth_ms = (time.perf_counter() - t0) * 1e3
    require(np.array_equal(back, views[0].gt().transpose(1, 2, 0)[
        :paeth_rows]), "the Paeth-filtered PNG read back differs")
    lazy = lazy_rank_run(dev, kernels_of, data, argv, lazy_iters,
                         3 * view_bytes, os.path.join(tmp, "lazy"))
    l1_rel_b = abs(lazy["l1_0"] / float(pre["l1"][0]) - 1.0)
    print(f"# (b) lazy storage, {lazy_iters} iterations of MultiRankTrainer "
          f"(world size 1, {lazy['backend']}), every camera lazy, decode "
          f"cache "
          f"{3 * view_bytes} bytes (3 views): {lazy['decodes']} decodes, the "
          f"cache's most {lazy['max_bytes']} bytes; step-0 L1 relative err "
          f"{l1_rel_b:.3e} against (a); held-out PSNR "
          f"{lazy['psnr_before']:.3f} -> {lazy['psnr_after']:.3f} dB; ground "
          f"truth {lazy['gt_host_ms']:.3f} ms of host a step (median; "
          f"{lazy['gt_miss_ms']:.3f} on a step that decoded); read_png "
          f"{png_ms:.2f} ms a view (filter 0, {views[0].width}x"
          f"{views[0].height}); Paeth rows {paeth_ms / paeth_rows:.3f} ms a "
          f"row ({paeth_ms:.1f} ms for {paeth_rows} rows, "
          f"{paeth_ms / paeth_rows * views[0].height:.0f} ms a view at that "
          f"rate) {tag}")
    require(lazy["decodes"] > 0, "(b): no lazy decode")
    require(lazy["max_bytes"] <= 3 * view_bytes, f"(b): the decode cache "
            f"held {lazy['max_bytes']} bytes over its budget")
    require(l1_rel_b <= 1e-5, f"(b): step-0 L1 {lazy['l1_0']} vs (a)'s "
            f"{float(pre['l1'][0])}")
    require(lazy["psnr_after"] > lazy["psnr_before"], "(b): held-out PSNR "
            "did not rise")

    # --- (c) device memory against the dataset's size
    mem = memory_runs(dev, kernels_of, mem_views, mem_size, mem_iters,
                      os.path.join(tmp, "mem"), tag)
    rec = dict(pre=pre, host=host, lazy=lazy, mem=mem, alternating=(one,
               other), png_ms=png_ms, paeth_ms_row=paeth_ms / paeth_rows)
    for r in (pre, host):
        del r["trainer"]
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"# storage phase: {rec['phase_s']:.1f} s in all {tag}")
    return rec, errs


def lazy_rank_run(dev, kernels_of, data, argv, iterations, cache_bytes,
                  model_path):
    """(b): ``MultiRankTrainer`` on a one-rank NCCL group over ``data`` with
    every camera lazy (``decode_mask`` refuses all) at threshold 0 and the
    decode cache made anew under ``GRENDEL_GT_CACHE_BYTES`` =
    ``cache_bytes``. Returns its decodes, the cache's most bytes after any
    step, step-0 L1, held-out PSNR before and after and the host's ground
    truth ms."""
    import torch.distributed as dist

    from grendel_tpu_torch import cameras as cam_mod
    from grendel_tpu_torch.data.scene import Scene
    from grendel_tpu_torch.engine.trainer_dist import MultiRankTrainer
    from grendel_tpu_torch.parallel import comm
    from grendel_tpu_torch.scripts import train

    i = argv.index("--iterations")
    a = train.build_parser().parse_args(
        argv[:i + 1] + [str(iterations)] + argv[i + 2:]
        + ["-m", model_path, "--preload_dataset_to_gpu_threshold", "0"])
    cfg = train.args_to_config(a)
    scene = Scene(data, eval_split=True, llffhold=a.llffhold, seed=a.seed,
                  decode_mask=lambda i, ci: False)
    old_env = os.environ.get("GRENDEL_GT_CACHE_BYTES")
    old_cache = cam_mod.GT_DECODE_CACHE
    os.environ["GRENDEL_GT_CACHE_BYTES"] = str(cache_bytes)
    cam_mod.GT_DECODE_CACHE = lru = cam_mod.DecodedLru()
    store = dist.TCPStore("127.0.0.1", free_port(), 1, True)
    comm.init_group(dev, rank=0, world_size=1, store=store)
    rec = {"l1": [], "bytes": [], "gt_ms": [], "misses": []}
    try:
        mt = MultiRankTrainer(cfg, scene, device=dev)
        backend = dist.get_backend()
        require(mt._gt_bank is None, "(b) built a ground-truth bank")
        real_step, real_rows = mt._step, mt._gt_rows

        def step(*args):
            for wrapper in kernels_of.values():
                wrapper.launches = 0
            state, m = real_step(*args)
            n = {name: w.launches for name, w in kernels_of.items()}
            require(all(v > 0 for v in n.values()), f"(b) step "
                    f"{len(rec['l1']) + 1}: a kernel did not launch: {n}")
            rec["l1"].append(m["l1"].sum())
            rec["bytes"].append(lru.bytes)
            return state, m

        def gt_rows(*args):
            n0 = cam_mod.LAZY_DECODE_COUNT[0]
            t0 = time.perf_counter()
            out = real_rows(*args)
            rec["gt_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["misses"].append(cam_mod.LAZY_DECODE_COUNT[0] > n0)
            return out

        mt._step, mt._gt_rows = step, gt_rows
        before = mt.eval_psnr(scene.test_cameras, 0)["psnr"]
        n0 = cam_mod.LAZY_DECODE_COUNT[0]
        mt.train()
        torch.cuda.synchronize()
        decodes = cam_mod.LAZY_DECODE_COUNT[0] - n0
        after = mt.eval_psnr(scene.test_cameras, 0)["psnr"]
    finally:
        comm.destroy_group()
        del store
        cam_mod.GT_DECODE_CACHE = old_cache
        if old_env is None:
            os.environ.pop("GRENDEL_GT_CACHE_BYTES", None)
        else:
            os.environ["GRENDEL_GT_CACHE_BYTES"] = old_env
    require(len(rec["l1"]) == iterations // BSZ,
            f"(b) ran {len(rec['l1'])} steps")
    miss_ms = [t for t, m in zip(rec["gt_ms"], rec["misses"]) if m]
    return dict(decodes=decodes, max_bytes=max(rec["bytes"]),
                backend=backend,
                l1_0=float(rec["l1"][0]), psnr_before=before,
                psnr_after=after, gt_host_ms=statistics.median(rec["gt_ms"]),
                gt_miss_ms=statistics.median(miss_ms) if miss_ms else 0.0)


def memory_scene(n_views, size, points=STORAGE_MEM_POINTS):
    """An in-memory scene of ``n_views`` cameras on one ring around the
    structured scene's target, each with a ``gt_loader`` that makes a
    cheap deterministic image from its uid (no raytrace, no disk)."""
    import types

    from grendel_tpu_torch.testing import (_structured_point_cloud,
                                           lookat_camera)

    w, h = size
    target = np.array([0.0, 0.42, 0.0])
    ramp = np.arange(w)

    def loader(uid):
        row = ((ramp + 7 * uid) % 256).astype(np.uint8)
        return np.ascontiguousarray(np.broadcast_to(row, (3, h, w)))

    cams = []
    for uid in range(n_views):
        az = 2 * np.pi * uid / n_views
        pos = target + np.array([4.0 * np.cos(0.6) * np.cos(az),
                                 -4.0 * np.sin(0.6),
                                 4.0 * np.cos(0.6) * np.sin(az)])
        cam = lookat_camera(pos, target, w, h, uid=uid)
        cam.gt_loader = (lambda uid=uid: loader(uid))
        cams.append(cam)
    centers = np.stack([c.camera_center for c in cams])
    extent = float(np.linalg.norm(centers - centers.mean(0), axis=-1).max()
                   * 1.1)
    return types.SimpleNamespace(
        train_cameras=cams, test_cameras=[], cameras_extent=extent,
        point_cloud=_structured_point_cloud(points, 0))


def memory_runs(dev, kernels_of, views, size, iterations, model_path, tag):
    """(c): the one-device ``Trainer`` for ``iterations`` on
    :func:`memory_scene` at ``views[0]`` and ``views[1]`` views at threshold
    0, then at ``views[1]`` preloaded: the peak of its training steps
    above what the process held before the trainer was built (the bank,
    built with the trainer, stays resident through them; the set-up's
    transients, the nearest-neighbour scales of the initial points above
    all, are not a step's and are left out), and the entry ceiling read
    from its first step. Hard checks: the two host-path peaks within 64
    MiB, the preloaded peak higher by at least the bank's bytes."""
    import gc

    from grendel_tpu_torch.engine.trainer import Trainer

    out = {}
    for n, preload in ((views[0], False), (views[1], False),
                       (views[1], True)):
        scene = memory_scene(n, size)
        cfg = loop_config(os.path.join(model_path, f"{n}_{preload}"),
                          iterations, ())
        cfg.dist.preload_dataset_to_gpu = preload
        cfg.dist.preload_dataset_to_gpu_threshold = 0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tr = Trainer(cfg, scene, device=dev)
        setup_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        require((tr._gt_bank is not None) == preload,
                f"(c) {n} views, preload {preload}: bank "
                f"{tr._gt_bank is not None}")
        real_step = tr._step

        def step(*a, real_step=real_step):
            for wrapper in kernels_of.values():
                wrapper.launches = 0
            state, m = real_step(*a)
            cnt = {k: w.launches for k, w in kernels_of.items()}
            require(all(v > 0 for v in cnt.values()),
                    f"(c) step: a kernel did not launch: {cnt}")
            return state, m

        tr._step = step
        tr.train(iterations)
        torch.cuda.synchronize()
        bank = 0 if tr._gt_bank is None else (tr._gt_bank.numel()
                                              * tr._gt_bank.element_size())
        key = (n, preload)
        out[key] = dict(peak=tr.peak_memory()[0] - base, bank=bank,
                        ceiling=tr.isect_capacity_ceiling,
                        readings=list(tr.hbm_readings), setup_s=setup_s)
        print(f"# (c) {n} views at {size[0]}x{size[1]}, "
              f"{'preloaded' if preload else 'threshold 0'}: peak "
              f"{out[key]['peak'] / 2**30:.3f} GiB above the "
              f"{base / 2**30:.2f} GiB held before it, bank {bank} bytes, "
              f"entry ceiling {out[key]['ceiling']} (readings "
              f"{out[key]['readings']}), set-up {setup_s:.1f} s {tag}")
        # the hook's closure holds the trainer too
        tr._step = real_step
        del tr, scene, step, real_step
    few, many, pre = (out[(views[0], False)], out[(views[1], False)],
                      out[(views[1], True)])
    d_host = many["peak"] - few["peak"]
    d_pre = pre["peak"] - many["peak"]
    print(f"# (c) peaks: {views[1]} views minus {views[0]} at threshold 0 "
          f"{d_host / 2**20:.2f} MiB; preloaded minus threshold 0 "
          f"{d_pre / 2**30:.3f} GiB against the bank's "
          f"{pre['bank'] / 2**30:.3f} GiB; ceiling without the bank minus "
          f"with it {many['ceiling'] - pre['ceiling']} entries against bank "
          f"/ 77.2 = {pre['bank'] / 77.2:.0f} {tag}")
    require(abs(d_host) < 64 * 2**20, f"(c): the host path's peak moved "
            f"{d_host / 2**20:.1f} MiB from {views[0]} to {views[1]} views")
    require(d_pre >= pre["bank"], f"(c): the preloaded peak is "
            f"{d_pre} bytes above the host path's, under the bank's "
            f"{pre['bank']}")
    return out


def step_kernel_times(timer, tag, k2_in, what, chunk=64):
    """K1, K2 and K2s timed on the inputs one training step (``what``)
    gave K2, beside the least time the card could take for them
    (``walked_pairs`` in steps of ``chunk`` entries). Returns each one's
    times and bound."""
    from grendel_tpu_torch.ops.rasterize_cuda import (rasterize_slots_fwd,
                                                      rasterize_slots_vjp_rows)

    (m2d, con, col, op, ids, lo, hi, px0, py0, tw, th, mpt, c_total, final_t,
     g, g_t) = k2_in
    blend_in = (m2d, con, col, op, ids, None, px0, py0, tw, th, mpt)
    fwd_kw = dict(tile_lo=lo, tile_hi=hi)
    bwd_kw = dict(fwd_kw, c_total=c_total, final_t=final_t, g=g, g_t=g_t)
    pairs, blended = walked_pairs(m2d, con, op, ids, lo, hi, px0, py0, tw,
                                  th, mpt, chunk)
    out = {}
    for name, fn, n_bytes, ops in (
            ("K1", lambda: rasterize_slots_fwd(*blend_in, **fwd_kw),
             m2d.shape[0] * 9 * 4 + ids.numel() * 4 + 4 * lo.numel() * 4
             + final_t.numel() * 4 * 4, K1_OPS_PER_PAIR * pairs),
            ("K2", lambda: rasterize_slots_vjp_rows(*blend_in, **bwd_kw),
             m2d.shape[0] * 9 * 4 + ids.numel() * (4 + 9 * 4)
             + 4 * lo.numel() * 4 + final_t.numel() * 8 * 4,
             K1_OPS_PER_PAIR * pairs + K2_OPS_PER_BLENDED * blended)):
        bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops / FP32_OPS_PER_S
        r = {"ms": timer.ms(fn, 20), "device_ms": timer.device_ms(fn, 20),
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        out[name] = r
        work = (f"{pairs} pairs walked" if name == "K1" else
                f"{pairs} pairs walked, {blended} blended "
                f"({blended / max(pairs, 1):.1%}), {ops} operations")
        print(f"# {name} on {what} ({final_t.shape[0]} slots, {m2d.shape[0]} "
              f"splats): {work}; {r['ms']:.4f} ms (device alone "
              f"{r['device_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) {tag}")
    out["K2s"] = k2s_times(timer, tag, rasterize_slots_vjp_rows(
        *blend_in, **bwd_kw), ids, m2d.shape[0], what)
    return out


def k2s_times(timer, tag, rows, ids, m, what):
    """K2s on K2's ``rows`` of one call (``ids`` its entries' Gaussians, m
    of them): its time with the ids already sorted (the VJP sorts them
    before K2 runs) beside the sort's, its plain version's on the card, the
    library's (one ``index_add_``, which adds with atomics in no fixed
    order) and its bound: what the function must move, each entry's id read
    once, the rows of the entries it sums (ids in [0, m): the list
    builders give every entry outside the spans the sentinel) read once,
    the m rows written. Returns the kernels line's fields."""
    from grendel_tpu_torch.ops.rasterize_cuda import segment_sum
    from grendel_tpu_torch.ops.rasterize_torch import segment_sum_rows

    ids = ids.to(torch.int32).contiguous()
    order = torch.sort(ids, stable=True)
    seg = torch.where((ids >= 0) & (ids < m), ids.long(),
                      torch.full_like(ids, m, dtype=torch.long))
    acc = torch.zeros(m + 1, rows.shape[1], device=rows.device)
    k2s = lambda: segment_sum(rows, m, order)  # noqa: E731
    lengths = torch.bincount(seg, minlength=m + 1)[:m]
    n_summed = int(lengths.sum())
    n_bytes = ids.numel() * 4 + (n_summed + m) * rows.shape[1] * 4
    r = {"ms": timer.ms(k2s, 20), "device_ms": timer.device_ms(k2s, 20),
         "plain_ms": timer.ms(lambda: segment_sum_rows(rows, ids, m), 20),
         "bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
         "library_ms": timer.ms(lambda: acc.index_add_(0, seg, rows), 20)}
    sort_ms = timer.ms(lambda: torch.sort(ids, stable=True), 20)
    print(f"# K2s on {what}: {ids.numel()} entry rows, {n_summed} of them "
          f"summed, into {m} Gaussians (segments of up to {int(lengths.max()) if m else 0} entries, "
          f"{int((lengths > 0).sum())} non-empty), {n_bytes} bytes; "
          f"{r['ms']:.4f} ms (device alone {r['device_ms']:.4f} ms), the "
          f"sort before it {sort_ms:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"library (index_add_) {r['library_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms (bytes) {tag}")
    return r


def kernel_launches(rows):
    """Launches per call of K1, K2, K2s and K3 in a profile's rows."""
    return {k: sum(n for _, n, key in rows if name in key)
            for k, name in (("K1", "rasterize_fwd"), ("K2", "rasterize_bwd"),
                            ("K2s", "segment_sum_kernel"), ("K3", "scan"))}


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
    from grendel_tpu_torch.ops.rasterize_torch import (
        rasterize_slots, rasterize_slots_bwd_rows)
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
    k2s = rasterize_cuda.segment_sum
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
    kernels_of = {"K1": k1, "K2": k2, "K2s": k2s, "K3": k3}
    state0 = clone_state(tr.state)
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

    # the same steps again, twice from the first step's state: like runs
    # repeat bit for bit
    def garden_steps(st):
        losses = []
        for _ in range(TRAIN_STEPS):
            st, m = tr.step(st)
            losses.append(float(m["loss"]))
        return st, losses

    repeat_check(f"{TRAIN_STEPS} garden train_steps", garden_steps, state0)
    del state0

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
    per_kernel = kernel_launches(rows)
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
    # its model directory stays for the tools of phase 12
    loop_dir = tempfile.TemporaryDirectory(dir=ROOT / "output")
    loop_rec, loop_errs, step_k2_in = loop_path(
        dev, tag, kernels_of, LOOP_SCENE, loop_dir.name)
    loop_launches = loop_rec["launches"]
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

    # --- 10. the distributed step ----------------------------------------
    dist_record, dist_errs = distributed_path(dev, tag, kernels_of,
                                              scene.cameras, tr)
    print(f"# distributed step device time per step: "
          + ", ".join(f"{k} {v['dev_ms']:.3f} ms" for k, v in
                      dist_record.items())
          + f"; train_step {step_dev_ms:.3f} ms {tag}")
    stamp(t_start, "distributed step checked")

    # --- 11. the distributed host loop on a one-rank group ---------------
    with tempfile.TemporaryDirectory(dir=ROOT / "output") as tmp:
        dist_loop_rec, dist_loop_errs = dist_loop_path(
            dev, tag, kernels_of, loop_rec, tmp)
    print(f"# distributed loop: launches {dist_loop_rec['launches']} over "
          f"{LOOP_ITERS // BSZ} steps ({dist_loop_rec['step_launches']} per "
          f"step) {tag}")
    stamp(t_start, "distributed loop checked")

    # --- 12. the tools on phase 7's model -----------------------------------
    t12 = time.perf_counter()
    tools_rec = tools_path(dev, tag, kernels_of, loop_rec, loop_dir.name,
                           step_dev_ms)
    tools_errs = tools_rec["errs"]
    struct_scene = loop_rec["scene"]        # phase 14 writes its views
    del loop_rec["scene"], loop_rec["trainer"]
    loop_dir.cleanup()
    print(f"# tools (phase 12): {time.perf_counter() - t12:.1f} s in all; "
          f"render {tools_rec['render_ms_per_view']:.3f} ms per view "
          f"{tag}")
    stamp(t_start, "tools checked")

    # --- 13. the 4K configuration through the CLI ------------------------
    timer = Timer()
    with tempfile.TemporaryDirectory(dir=ROOT / "output") as tmp:
        _, fourk_errs = fourk_path(dev, tag, kernels_of, timer, tmp)
    stamp(t_start, "4K configuration checked")

    # --- 14. host-resident ground truth ----------------------------------
    with tempfile.TemporaryDirectory(dir=ROOT / "output") as tmp:
        _, storage_errs = storage_path(dev, tag, kernels_of, struct_scene,
                                       tmp)
    del struct_scene
    stamp(t_start, "host-resident ground truth checked")

    # --- 9. kernel timings -------------------------------------------------
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

    # K2 alone (its rows), then K2s on them; the backward also sorts the
    # entry ids, and the whole VJP is timed beside the two
    k2_rows = lambda: rasterize_cuda.rasterize_slots_vjp_rows(  # noqa: E731
        *blend_in, **bwd_kw)
    k2_ms = timer.ms(k2_rows, 20)
    k2_dev_ms = timer.device_ms(k2_rows, 20)
    k2_plain_ms = timer.ms(
        lambda: rasterize_slots_bwd_rows(*blend_in, **bwd_kw), 1)
    vjp_ms = timer.ms(lambda: k2(*blend_in, **bwd_kw), 20)
    # inputs: the splats, ids and spans, c_total, final_t and the two
    # cotangents (8 floats per pixel); output: 9 floats per entry
    k2_bytes = splat_bytes + n_pix * 8 * 4 + ids.numel() * 9 * 4
    k2_bytes_ms = 1e3 * k2_bytes / HBM_BYTES_PER_S
    k2_ops = K1_OPS_PER_PAIR * pairs + K2_OPS_PER_BLENDED * blended
    k2_ops_ms = 1e3 * k2_ops / FP32_OPS_PER_S
    k2_bound = max(k2_bytes_ms, k2_ops_ms)
    k2_bound_by = "operations" if k2_ops_ms >= k2_bytes_ms else "bytes"
    print(f"# K2: {k2_ops} operations, {k2_bytes} bytes; {k2_ms:.4f} ms "
          f"(device alone {k2_dev_ms:.4f} ms), plain {k2_plain_ms:.2f} ms, "
          f"bound {k2_bound:.4f} ms ({k2_bound_by}); the whole VJP (sort, "
          f"K2, K2s) {vjp_ms:.4f} ms {tag}")
    k2s_row = k2s_times(timer, tag, k2_rows(), ids, m, "the garden")
    # K1 and K2 on the inputs of the loop's last step: a trained scene
    # blends far more of its walked pairs than the random garden
    step_kernel_times(timer, tag, step_k2_in, "a loop step")

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
    # launches: K1-K3 and K2s over the host training loop's steps, K4 and
    # K5 over the microbenchmark's run; max_abs_err: the larger of the
    # checks on the garden's inputs, on the last step of each host loop
    # (phases 7, 11, 13 and 14), on the simulated distributed steps and on
    # the tools' inputs (phase 12: a render-tool batch, a profile_step
    # full_step and isect) (K1-K3; K2s in every check K2 has), and of the
    # microbenchmark's own check and the odd chunk count's (K4, K5)
    kernels_line = {"kernels": [
        {"name": "rasterize_fwd", "route": "cuda",
         "source": "grendel_tpu_torch/csrc/rasterize_fwd.cu",
         "replaces": "grendel_tpu/ops/rasterize_pallas.py:181",
         "launches": loop_launches["K1"],
         "max_abs_err": max(k1_err, loop_errs["K1"], dist_errs["K1"],
                            dist_loop_errs["K1"], tools_errs["K1"],
                            fourk_errs["K1"], storage_errs["K1"]),
         "ms": k1_ms, "device_ms": k1_dev_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_bound_by, "library_ms": None},
        # K3's times are per render_batch (a train_step builds its tile
        # lists once, at the same two shapes): the sum over both launches,
        # the library's of the one call per shape
        {"name": "scan_i32", "route": "cuda",
         "source": "grendel_tpu_torch/csrc/scan.cu",
         "replaces": "grendel_tpu/ops/scan_pallas.py:65",
         "launches": loop_launches["K3"],
         "max_abs_err": max(k3_err, loop_errs["K3"], dist_errs["K3"],
                            dist_loop_errs["K3"], tools_errs["K3"],
                            fourk_errs["K3"], storage_errs["K3"]),
         "ms": k3_row["ms"], "device_ms": k3_row["device_ms"],
         "plain_ms": k3_row["plain_ms"],
         "bound_ms": k3_row["bound_ms"], "bound_by": "bytes",
         "library_ms": k3_row["library_ms"]},
        {"name": "rasterize_bwd", "route": "cuda",
         "source": "grendel_tpu_torch/csrc/rasterize_bwd.cu",
         "replaces": "grendel_tpu/ops/rasterize_pallas.py:262",
         "launches": loop_launches["K2"],
         "max_abs_err": max(k2_err, loop_errs["K2"], dist_errs["K2"],
                            dist_loop_errs["K2"], tools_errs["K2"],
                            fourk_errs["K2"], storage_errs["K2"]),
         "ms": k2_ms, "device_ms": k2_dev_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_bound_by, "library_ms": None},
        # K2s: the same function as the segment sum that follows the TPU
        # kernel (no pallas_call of its own); on the garden's K2 rows
        {"name": "segment_sum", "route": "cuda",
         "source": "grendel_tpu_torch/csrc/segment_sum.cu",
         "replaces": "grendel_tpu/ops/rasterize_pallas.py:648",
         "launches": loop_launches["K2s"], "max_abs_err": max(K2S_ERRS),
         **k2s_row},
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
