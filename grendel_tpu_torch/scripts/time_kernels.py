"""Time K1, K2, K2s, K3 and K5, and the garden's training step, of
whichever tree of the port is on the path.

    python3 chip_smoke.py --save-k2 output
    PYTHONPATH=<tree> python3 grendel_tpu_torch/scripts/time_kernels.py \\
        output/k2_garden.pt output/k2_step.pt output/k2s_4k.pt

A file of K2's inputs holds the arguments of one call of K2
(``rasterize_cuda._blend_vjp``: the splats, the tile lists, the forward's
outputs and the cotangents): on the garden with random cotangents, and
on the training loop's last step with the loss's. A file of K2s's inputs
(``k2s_4k.pt``) holds the entry ids, K2's rows and M of the 4K step. The
script calls only the public wrappers ``rasterize_slots_fwd``,
``rasterize_slots_vjp``, ``rasterize_slots_vjp_rows``, ``segment_sum``,
``cumsum_i32_multi`` and ``scattered_checksum`` of the
``grendel_tpu_torch`` the path gives it, so that two trees of the port (a
parent and a change) can be timed on the same inputs on one card, one
after the other. It times K1 on each saved K2 call's forward inputs (the
file's first 12 fields) and the backward on the whole call (K2; in a
tree that has them, with the sort of the entry ids and K2s, the
per-Gaussian sum of K2's rows); then, on K2's rows of that call and on
each K2s file, the stable sort of the entry ids and K2s alone, with a
checksum of K2s's output bits (two trees that sum in the same order print
the same one); with checksums of K1's outputs and of the gradients; K3 on
random channels at the garden's two scan shapes (``--k3`` C,M pairs)
beside one ``torch.cumsum`` call; and K5 on the DMA microbenchmark's
default inputs from its seed (``microbench_dma.make_inputs``, 1,048,576
ids into a table of 262,144 rows) at both row widths, no arithmetic.
Times are medians of CUDA events around single launches with the L2
flushed before each, on two clocks: as the card sees the call, which
counts any wait for the host to reach the launch, and the device's time
alone. Last, the device time of one garden ``train_step``
(``testing.garden_training``, bsz 2 at 1296x840): the sum over its
kernels under ``torch.profiler``, per step over 5 steps after 3 warm-ups,
with the launches per step, the number that holds to 0.5% between
processes. The timer is ``kernels.cold_ms`` of the tree this script
belongs to, loaded by its path (it needs only torch), so that every tree
is timed the same way.
"""

import argparse
import importlib.util
import subprocess
from pathlib import Path

import torch


def _cold_ms():
    path = Path(__file__).resolve().parents[1] / "kernels.py"
    spec = importlib.util.spec_from_file_location("_timer_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.cold_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("k2_inputs", nargs="*")
    ap.add_argument("--k3", nargs="*", default=["1,524288", "4,1179648"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels.py needs a CUDA card")
    from grendel_tpu_torch.ops.dma_bench import ROW_WIDTHS, scattered_checksum
    from grendel_tpu_torch.ops.rasterize_cuda import (
        rasterize_slots_fwd, rasterize_slots_vjp, rasterize_slots_vjp_rows,
        segment_sum)
    from grendel_tpu_torch.ops.scan_cuda import cumsum_i32_multi
    from grendel_tpu_torch.scripts.microbench_dma import make_inputs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    cold_ms = _cold_ms()

    def clocks(fn, reps):
        return (f"{cold_ms(fn, reps, flush):.4f} ms (device alone "
                f"{cold_ms(fn, reps, flush, spin=True):.4f} ms)")

    def k2s(what, ids, rows, m):
        ids = ids.to(torch.int32).contiguous()
        order = torch.sort(ids, stable=True)
        bits = segment_sum(rows, m, order).view(torch.int32).long().sum()
        print(f"# sort on {what} ({ids.numel()} entries): "
              f"{clocks(lambda: torch.sort(ids, stable=True), 20)} [{card}]")
        print(f"# K2s on {what} ({ids.numel()} entries, {m} Gaussians): "
              f"{clocks(lambda: segment_sum(rows, m, order), 20)}, output "
              f"bits checksum {int(bits)} [{card}]")

    for path in args.k2_inputs:
        saved = torch.load(path, map_location="cuda")
        if len(saved) == 3:                 # K2s's inputs: ids, rows, M
            k2s(path, *saved)
            continue
        (m2d, con, col, op, ids, lo, hi, px0, py0, tw, th, mpt, c_total,
         final_t, g, g_t) = saved

        def k1():
            return rasterize_slots_fwd(m2d, con, col, op, ids, None, px0, py0,
                                       tw, th, mpt, tile_lo=lo, tile_hi=hi)

        checksum = sum(float(x.abs().sum()) for x in k1())
        print(f"# K1 on {path} ({final_t.shape[0]} slots, {m2d.shape[0]} "
              f"splats): {clocks(k1, 20)}, sum |out| {checksum:.6e} [{card}]")

        def k2():
            return rasterize_slots_vjp(
                m2d, con, col, op, ids, None, px0, py0, tw, th, mpt,
                tile_lo=lo, tile_hi=hi, c_total=c_total, final_t=final_t,
                g=g, g_t=g_t)

        checksum = sum(float(x.abs().sum()) for x in k2())
        print(f"# K2 on {path} ({final_t.shape[0]} slots, {m2d.shape[0]} "
              f"splats): {clocks(k2, 20)}, sum |grads| "
              f"{checksum:.6e} [{card}]")
        k2s(path, ids, rasterize_slots_vjp_rows(
            m2d, con, col, op, ids, None, px0, py0, tw, th, mpt, tile_lo=lo,
            tile_hi=hi, c_total=c_total, final_t=final_t, g=g, g_t=g_t),
            m2d.shape[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in args.k3:
        c, m = (int(v) for v in shape.split(","))
        xs = [torch.randint(0, 64, (m,), generator=gen, device="cuda",
                            dtype=torch.int32) for _ in range(c)]
        stacked = torch.stack(xs)
        lib = ((lambda: torch.cumsum(xs[0], 0, dtype=torch.int32)) if c == 1
               else (lambda: torch.cumsum(stacked, 1, dtype=torch.int32)))
        print(f"# K3 C={c} M={m}: {clocks(lambda: cumsum_i32_multi(xs), 50)}"
              f", torch.cumsum ({'the channel' if c == 1 else 'stacked'}) "
              f"{clocks(lib, 50)} [{card}]")
    for width in ROW_WIDTHS:
        table, ids, _ = make_inputs(262_144, 1_048_576, width, "cuda", seed=0)
        checksum = int(scattered_checksum(table, ids, 0).long().sum())
        print(f"# K5 W={width} rows={ids.shape[0]}: "
              f"{clocks(lambda: scattered_checksum(table, ids, 0), 20)}, "
              f"checksum sum {checksum} [{card}]")
    ms, launches = step_device_ms()
    print(f"# garden train_step device time: {ms:.3f} ms per step, "
          f"{launches:.0f} launches per step (profiler, 5 steps) [{card}]")
    return 0


def step_device_ms(steps: int = 5):
    """Device ms and kernel launches per garden train_step: the sum of the
    profiler's device time over its kernels, over ``steps`` steps after 3
    warm-ups."""
    from torch.profiler import ProfilerActivity, profile

    from grendel_tpu_torch.testing import garden_training

    tr = garden_training(0, torch.device("cuda"))
    state = tr.state
    for _ in range(3):
        state, _ = tr.step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = tr.step(state)
        torch.cuda.synchronize()
    us = n = 0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
            n += e.count
    return us / 1e3 / steps, n / steps


if __name__ == "__main__":
    raise SystemExit(main())
