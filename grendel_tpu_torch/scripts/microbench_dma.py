"""Scattered-row gather microbenchmark on the card (kernels K4 and K5).

Counterpart of scripts/microbench_dma.py. The question it measures: can a
blend kernel gather its Gaussians' payload rows itself, one scattered
64-byte row per entry, instead of reading a table gathered beforehand?
K1 and K2 already read their splats through ``gauss_ids``; this gives a
redesign of them its yardstick on this card: the ns per row of

  * ``torch_gather``: ``table[ids].sum()``, one PyTorch gather (the
    counterpart of the JAX script's ``xla_gather``);
  * ``dma_contig``: K4, one contiguous (16, 128) f32 chunk per block;
  * ``dma_scattered``: K5, 128 scattered rows per block;
  * ``dma_scattered_vpu``: K5 with ``vpu_iters`` rounds of arithmetic on
    the gathered tile, about a blend kernel's load.

Every mode is timed with CUDA events over ``--steps`` back-to-back calls
after 3 warm-up calls, and the kernels' checksums are held bit-equal to
their plain versions before any timing. ``--row_width`` 16 is the real
64-byte payload row (a 16 MiB table at the default ``--n``, which the
card's 50 MB L2 holds); 128 is the JAX script's padded row (128 MiB,
which it does not). Run from the repository root:

    python -m grendel_tpu_torch.scripts.microbench_dma [--row_width 128]

It prints one JSON line. With ``--device cpu`` every mode runs its plain
version and the times are the host's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..device import resolve_device
from ..ops import dma_bench as D

MODES = ("torch_gather", "dma_contig", "dma_scattered", "dma_scattered_vpu")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=262_144, help="table rows")
    p.add_argument("--cap", type=int, default=1_048_576,
                   help="entries gathered per pass")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--vpu_iters", type=int, default=24,
                   help="arithmetic rounds per element in dma_scattered_vpu")
    p.add_argument("--row_width", type=int, default=16,
                   choices=list(D.ROW_WIDTHS),
                   help="f32 per table row: 16 (64 bytes) or 128")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0)
    return p


def make_inputs(n: int, cap: int, row_width: int, device, seed: int = 0):
    """(table (n, W), ids (cap // 128 * 128,) int32, src (cap // 128, 16,
    128)) from one generator seeded with ``seed``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    n_chunks = cap // D.IDS_PER_CHUNK
    table = torch.randn((n, row_width), generator=g, device=dev)
    ids = torch.randint(0, n, (n_chunks * D.IDS_PER_CHUNK,), generator=g,
                        device=dev, dtype=torch.int32)
    src = torch.randn((n_chunks,) + D.CHUNK_SHAPE, generator=g, device=dev)
    return table, ids, src


def check_checksums(table, ids, src, vpu_iters: int) -> dict:
    """Raise unless K4 and K5 (at 0 and ``vpu_iters`` rounds) are
    bit-equal to their plain versions. Returns each kernel's largest
    |kernel - plain| over its checksums (0 when they are bit-equal)."""
    pairs = [("dma_contig", D.contig_checksum(src),
              D.contig_checksum_plain(src))]
    for it in sorted({0, vpu_iters}):
        pairs.append((f"dma_scattered vpu_iters={it}",
                      D.scattered_checksum(table, ids, it),
                      D.scattered_checksum_plain(table, ids, it)))
    err = {"dma_contig": 0, "dma_scattered": 0}
    for name, got, want in pairs:
        if got.dtype != torch.int32 or not torch.equal(got, want):
            bad = int((got != want).sum())
            raise RuntimeError(f"{name}: {bad} of {want.numel()} checksums "
                               f"differ from the plain version")
        key = name.split()[0]
        err[key] = max(err[key], int((got.long() - want.long()).abs().max()))
    return err


def time_ms(fn, steps: int, device) -> float:
    """Mean ms of one call over ``steps`` back-to-back calls after 3
    warm-ups: CUDA events on the card, the host clock on the CPU."""
    for _ in range(3):
        fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / steps
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / steps


def run(n: int = 262_144, cap: int = 1_048_576, steps: int = 20,
        vpu_iters: int = 24, row_width: int = 16, device="cuda",
        seed: int = 0) -> dict:
    """Build the inputs, check the checksums and time every mode. Returns
    the result line as a dict."""
    dev = resolve_device(device)
    table, ids, src = make_inputs(n, cap, row_width, dev, seed)
    err = check_checksums(table, ids, src, vpu_iters)
    fns = {
        "torch_gather": lambda: table[ids].sum(),
        "dma_contig": lambda: D.contig_checksum(src),
        "dma_scattered": lambda: D.scattered_checksum(table, ids, 0),
        "dma_scattered_vpu": lambda: D.scattered_checksum(table, ids,
                                                          vpu_iters),
    }
    rows = ids.shape[0]
    ms = {m: time_ms(fns[m], steps, dev) for m in MODES}
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "row_width": row_width, "n": n, "rows": rows,
           # the table rows the ids touch: the least a gather must read
           "distinct_rows": int(ids.unique().numel()),
           "vpu_iters": vpu_iters, "steps": steps,
           "checksum_max_abs_err": err}
    out.update({f"{m}_ms": ms[m] for m in MODES})
    out.update({f"{m}_ns_per_row": ms[m] * 1e6 / rows for m in MODES})
    return out


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    if a.cap < D.IDS_PER_CHUNK:
        raise SystemExit(f"--cap must be at least {D.IDS_PER_CHUNK}")
    res = run(a.n, a.cap, a.steps, a.vpu_iters, a.row_width, a.device,
              a.seed)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
