#!/usr/bin/env python3
"""Chip smoke run of grendel_tpu_torch, the PyTorch + CUDA port, on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which fails the run:

  1. print the card (nvidia-smi name and power limit) and the versions;
  2. build the port's CUDA kernels from csrc/ (one nvcc per source, in
     parallel) and print the build time and the compiler's register report;
  3. scan kernel K3 against its plain version: bit-equal at the main
     path's shapes and at odd lengths;
  4. blend kernel K1 against its plain version on the main path's real
     tile lists: max abs error <= 1e-5 on colors and on final_t;
  5. the main path at full width: the garden-scale model (200,000 live
     Gaussians in a capacity of 262,144, SH 3) saved to PLY, loaded on the
     card and rendered by render_batch for 2 cameras at 1296x840 with
     32x16 tiles; launch counters must show both kernels ran, the images
     must be finite and sane, and a small scene rendered on the card must
     agree with the plain CPU reference;
  6. timings: render_batch (host clock, median of 20 after warm-up) and
     each kernel, its plain version and the library call (CUDA events,
     with the L2 cache flushed before each launch), beside the least time
     the card could take.

Prints one ``{"kernels": [...]}`` line, then as its last line
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
TILE_W, TILE_H, MAX_PER_TILE, BSZ = 32, 16, 2048, 2
K1_TOL = 1e-5


def require(ok, what):
    if not ok:
        raise RuntimeError(f"chip smoke failed: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Median device time of one call, from CUDA events around each launch,
    with the L2 cache flushed before every launch (the 50 MB L2 would
    otherwise hold a previous launch's inputs)."""

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps):
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def walked_pairs(m2d, con, op, ids, lo, hi, px0, py0, chunk=64):
    """(entry, pixel) pairs the front-to-back walk must evaluate: per
    pixel, the entries of its slot's span up to and including the one that
    stops it (or the whole span)."""
    from grendel_tpu_torch.ops.blend import T_EPS, splat_alpha
    from grendel_tpu_torch.ops.rasterize_torch import slot_pixels

    lo, hi = lo.long(), hi.long()
    hi_eff = torch.minimum(hi, lo + MAX_PER_TILE)
    px, py = slot_pixels(px0, py0, TILE_W, TILE_H)
    t = torch.ones_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    pairs = torch.zeros((), dtype=torch.int64, device=px.device)
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
            t = torch.where(live & ~stop, t_after, t)
            done = done | stop
    return int(pairs)


def profile(fn, calls, top=14):
    """Device time by kernel over ``calls`` calls of ``fn`` under
    torch.profiler, per call, and the share of the window's wall time the
    device was busy (the profiler's own overhead lengthens the window)."""
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from grendel_tpu_torch import kernels
    from grendel_tpu_torch.cameras import batch_camera_arrays, camera_arrays
    from grendel_tpu_torch.convert import params_from_numpy
    from grendel_tpu_torch.engine import render as R
    from grendel_tpu_torch.engine.gaussian_io import load_ply, save_ply
    from grendel_tpu_torch.models.gaussian_model import activated
    from grendel_tpu_torch.ops import isect as I
    from grendel_tpu_torch.ops import rasterize_cuda, scan_cuda
    from grendel_tpu_torch.ops.projection import (ProjectedSplats,
                                                  project_gaussians,
                                                  project_gaussians_batched)
    from grendel_tpu_torch.ops.rasterize_torch import rasterize_slots
    from grendel_tpu_torch.testing import (garden_scene, make_test_camera,
                                           params_fields, random_gaussians)
    from grendel_tpu_torch.utils.hbm import mantissa_round_cap

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"# card: {card}")
    print(f"# python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    tag = f"[{card}]"

    # --- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    logs = kernels.build()
    print(f"# build: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(logs) or 'nothing (cached)'}")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
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
    act = activated(params)
    ca0 = camera_arrays(scene.cameras[0], dev)
    s0 = project_gaussians(act.means3d, act.scales, act.quats, act.opacities,
                           act.sh, alive, ca0.viewmat, ca0.full_proj,
                           ca0.campos, ca0.tanfov, h, w, sh)
    tiles_x, tiles_y = -(-w // TILE_W), -(-h // TILE_H)
    probe = I.isect_tiles(s0.means2d, s0.radii, s0.depths, TILE_W, TILE_H,
                          tiles_x, tiles_y, 1 << 23, opacities=s0.opacities)
    n_isect, n_kept = int(probe.num_isects), int(probe.num_kept)
    isect_cap = mantissa_round_cap(1.15 * n_isect)
    blend_cap = min(mantissa_round_cap(1.15 * n_kept), isect_cap)
    cfg = R.RenderConfig(img_h=h, img_w=w, tile_w=TILE_W, tile_h=TILE_H,
                         isect_capacity=isect_cap, blend_capacity=blend_cap,
                         max_per_tile=MAX_PER_TILE, backend="cuda")
    print(f"# garden: {int(alive.sum())} live / {alive.shape[0]}, {w}x{h}, "
          f"bsz {BSZ}, tiles {TILE_W}x{TILE_H}: {n_isect} isects/cam "
          f"({n_kept} post-cull), capacity {isect_cap}/cam, blend "
          f"{blend_cap}/cam")

    # the blend's inputs exactly as render_batch builds them
    splats = project_gaussians_batched(act.means3d, act.scales, act.quats,
                                       act.opacities, act.sh, alive, cams,
                                       h, w, sh)
    n_univ = splats.means2d.shape[0] * splats.means2d.shape[1]
    flat = ProjectedSplats(*(x.reshape((n_univ,) + x.shape[2:])
                             for x in splats))
    isect = I.isect_tile_rows_blocked(
        flat.means2d, flat.radii, flat.depths, BSZ, TILE_W, TILE_H, tiles_x,
        tiles_y, BSZ * isect_cap, opacities=flat.opacities)
    ids, tlo, thi = I.compact_entries_blocked(
        isect.gauss_ids, isect.tile_lo, isect.tile_hi, BSZ, cfg.num_tiles,
        isect_cap, blend_cap)
    px0, py0 = R._slot_origins(BSZ * cfg.num_tiles, cfg, dev)
    blend_in = (flat.means2d, flat.conics, flat.colors, flat.opacities, ids,
                None, px0, py0, TILE_W, TILE_H, MAX_PER_TILE)
    blend_kw = dict(tile_lo=tlo, tile_hi=thi)

    # --- 3. K3 against its plain version --------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    scan_shapes = [(1, n_univ), (4, BSZ * isect_cap)]   # per render_batch
    k3_err = 0
    for c, m in scan_shapes + [(1, 1_200_000), (4, 1_200_000), (4, 524_288),
                               (1, 1), (3, 4097), (2, 99_999), (8, 12_305)]:
        xs = [torch.randint(-5000, 5000, (m,), generator=gen, device=dev,
                            dtype=torch.int32) for _ in range(c)]
        got = scan_cuda.cumsum_i32_multi(xs)
        want = scan_cuda.cumsum_i32_multi_plain(xs)
        torch.cuda.synchronize()
        for g, wnt in zip(got, want):
            require(g.dtype == torch.int32 and torch.equal(g, wnt),
                    f"K3 differs from its plain version at C={c} M={m}")
            k3_err = max(k3_err, int((g.long() - wnt.long()).abs().max()))
    print(f"# K3 scan: bit-equal to plain at {len(scan_shapes) + 7} shapes")

    # --- 4. K1 against its plain version --------------------------------
    col_k, t_k = rasterize_cuda.rasterize_slots_fwd(*blend_in, **blend_kw)
    col_p, t_p = rasterize_slots(*blend_in, **blend_kw)
    torch.cuda.synchronize()
    k1_err = max(float((col_k - col_p).abs().max()),
                 float((t_k - t_p).abs().max()))
    require(bool(torch.isfinite(col_k).all() and torch.isfinite(t_k).all()),
            "K1 output not finite")
    print(f"# K1 blend: max abs err vs plain {k1_err:.3e} over "
          f"{t_k.shape[0]} slots x {t_k.shape[1]} px (tol {K1_TOL})")
    require(k1_err <= K1_TOL, f"K1 differs from its plain version: {k1_err}")

    # --- 5. the main path ------------------------------------------------
    bg = torch.tensor([0.0, 0.0, 0.0], device=dev)
    scan_cuda.cumsum_i32_multi.launches = 0
    rasterize_cuda.rasterize_slots_fwd.launches = 0
    imgs, _, aux = R.render_batch(params, alive, cams, sh, cfg, bg=bg)
    torch.cuda.synchronize()
    launches = {"K1": rasterize_cuda.rasterize_slots_fwd.launches,
                "K3": scan_cuda.cumsum_i32_multi.launches}
    print(f"# main path launches: {launches}")
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the main path did not launch: {launches}")
    require(imgs.shape == (BSZ, 3, h, w), f"image shape {tuple(imgs.shape)}")
    require(bool(torch.isfinite(imgs).all()), "non-finite image")
    require(int(aux.num_isects[0]) <= BSZ * isect_cap,
            f"isect overflow {int(aux.num_isects[0])} > {BSZ * isect_cap}")
    mean = float(imgs.mean())
    print(f"# render_batch image mean {mean:.4f}, final_t mean "
          f"{float(aux.final_t.mean()):.4f}")
    require(0.02 < mean < 0.98, f"image mean {mean} outside (0.02, 0.98)")
    # the main path's blend is the kernel run checked in phase 4
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

    # --- 6. timings --------------------------------------------------------
    for _ in range(2):
        R.render_batch(params, alive, cams, sh, cfg, bg=bg)
    torch.cuda.synchronize()
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        R.render_batch(params, alive, cams, sh, cfg, bg=bg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    render_ms = statistics.median(walls)
    print(f"# render_batch bsz {BSZ} {w}x{h}: median {render_ms:.3f} ms "
          f"(min {min(walls):.3f}, max {max(walls):.3f}) over 20 calls "
          f"= {BSZ * 1e3 / render_ms:.1f} images/s {tag}")

    profile(lambda: R.render_batch(params, alive, cams, sh, cfg, bg=bg), 5)

    timer = Timer()
    k1_ms = timer.ms(lambda: rasterize_cuda.rasterize_slots_fwd(
        *blend_in, **blend_kw), 20)
    k1_plain_ms = timer.ms(lambda: rasterize_slots(*blend_in, **blend_kw), 3)
    pairs = walked_pairs(flat.means2d, flat.conics, flat.opacities, ids, tlo,
                         thi, px0, py0)
    entries = int((torch.minimum(thi, tlo + MAX_PER_TILE) - tlo).sum())
    m = flat.means2d.shape[0]
    k1_bytes = (m * 9 * 4 + ids.numel() * 4 + 4 * tlo.numel() * 4
                + t_k.numel() * 4 * 4)
    k1_bytes_ms = 1e3 * k1_bytes / HBM_BYTES_PER_S
    k1_ops_ms = 1e3 * K1_OPS_PER_PAIR * pairs / FP32_OPS_PER_S
    k1_bound = max(k1_bytes_ms, k1_ops_ms)
    k1_bound_by = "operations" if k1_ops_ms >= k1_bytes_ms else "bytes"
    print(f"# K1: {entries} entries walked in spans, {pairs} (entry, pixel) "
          f"pairs to stop, {k1_bytes} bytes; {k1_ms:.4f} ms, plain "
          f"{k1_plain_ms:.2f} ms, bound {k1_bound:.4f} ms ({k1_bound_by}) {tag}")

    k3 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for c, m_len in scan_shapes:
        xs = [torch.randint(0, 64, (m_len,), generator=gen, device=dev,
                            dtype=torch.int32) for _ in range(c)]
        stacked = torch.stack(xs)
        row = {
            "ms": timer.ms(lambda: scan_cuda.cumsum_i32_multi(xs), 50),
            "plain_ms": timer.ms(
                lambda: scan_cuda.cumsum_i32_multi_plain(xs), 50),
            "library_ms": timer.ms(
                lambda: torch.cumsum(stacked, 1, dtype=torch.int32), 50),
            "bound_ms": 1e3 * 2 * c * m_len * 4 / HBM_BYTES_PER_S,
        }
        print(f"# K3 C={c} M={m_len}: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, torch.cumsum {row['library_ms']:.4f}"
              f" ms, bound {row['bound_ms']:.4f} ms (bytes) {tag}")
        for k in k3:
            k3[k] += row[k]

    kernels_line = {"kernels": [
        {"name": "rasterize_fwd", "route": "cuda",
         "source": "grendel_tpu_torch/csrc/rasterize_fwd.cu",
         "replaces": "grendel_tpu/ops/rasterize_pallas.py:181",
         "launches": launches["K1"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_bound_by, "library_ms": None},
        # K3's numbers are per render_batch: the sum over its launches at
        # the main path's two shapes
        {"name": "scan_i32", "route": "cuda",
         "source": "grendel_tpu_torch/csrc/scan.cu",
         "replaces": "grendel_tpu/ops/scan_pallas.py:65",
         "launches": launches["K3"], "max_abs_err": k3_err,
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": "bytes",
         "library_ms": k3["library_ms"]},
    ]}
    print(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
