"""The dry run's all-to-all accounting across world sizes.

Counterpart of scripts/ici_scaling.py, whose name it keeps. It runs the
full-schedule dry run (``python -m grendel_tpu_torch.graft_entry --n k``,
``graft_entry.dryrun_multichip``) once per world size k, each in a
subprocess, and tabulates from each summary line the per-rank all-to-all
accounting: the tuned ``send_cap``, the forward payload in MB per rank and
step, the capacity events the tuner fired, n_alive, and the loss drift and
held-out PSNR against one rank. On GPUs the ranks' links are NVLink or
PCIe, through NCCL, one rank per card; with ``--device cpu`` the ranks are
gloo processes on this host.

    python -m grendel_tpu_torch.scripts.ici_scaling [--device cpu]
        [--sizes 2 4 8] [--out FILE.json]

On the card the sizes default to the powers of two from 2 up to the card
count (1 on a machine with one card), and a size above the card count
raises before anything runs; on the CPU they default to 2, 4 and 8. A run
that missed a bound of its parity against one rank stays in the table,
marked FAILED, and the script exits with 1.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the keys of scripts/ici_scaling.py, read from a summary line
KEYS = (("send_cap", r"a2a_send_cap=(\d+)/dest", int),
        ("a2a_fwd_mb_dev_step", r"a2a_fwd_volume=([\d.]+)MB", float),
        ("n_alive", r"n_alive=(\d+)", int),
        ("events", r"capacity_events=(\[[^\]]*\])", None),
        ("max_rel_loss_diff", r"max_rel_loss_diff=([\d.e+-]+)", float),
        ("dpsnr", r"dpsnr=([\d.]+)dB", float))


def parse_line(line: str) -> dict:
    """The keys of a ``dryrun_multichip(n): ok, ...`` summary line (either
    package's), as scripts/ici_scaling.py reads them."""
    rec = {}
    for key, rx, cast in KEYS:
        m = re.search(rx, line)
        if m:
            rec[key] = cast(m.group(1)) if cast else m.group(1)
    return rec


def default_sizes(device: str) -> list:
    if device == "cpu":
        return [2, 4, 8]
    import torch

    count = torch.cuda.device_count()
    sizes = [1 << k for k in range(1, 8) if (1 << k) <= count]
    return sizes or [1]


def run_size(n: int, device: str) -> dict:
    """The dry run at ``n`` ranks in a subprocess: its summary line, extras
    line and keys, and ``ok``. A run that printed its summary line and then
    failed its parity against one rank (``FAILED`` in the line) is kept,
    with ``ok`` False; any other failure raises."""
    out = subprocess.run(
        [sys.executable, "-m", "grendel_tpu_torch.graft_entry", "--n",
         str(n), "--device", device],
        capture_output=True, text=True, timeout=3600, cwd=ROOT)
    lines = out.stdout.splitlines()
    line = [s for s in lines if s.startswith(f"dryrun_multichip({n}):")]
    extras = [s for s in lines
              if s.startswith(f"dryrun_multichip({n}) extras:")]
    ok = out.returncode == 0
    if not (line and extras) or (not ok and "FAILED" not in line[-1]):
        raise RuntimeError(f"the dry run at {n} ranks failed (rc "
                           f"{out.returncode}):\n{out.stdout[-2000:]}"
                           f"{out.stderr[-4000:]}")
    return dict({"n_devices": n, "line": line[-1], "extras": extras[-1],
                 "ok": ok}, **parse_line(line[-1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--sizes", type=int, nargs="+", default=None)
    ap.add_argument("--out", type=str, default="")
    a = ap.parse_args(argv)
    sizes = a.sizes or default_sizes(a.device)
    if a.device == "cuda":
        import torch

        count = torch.cuda.device_count()
        over = [n for n in sizes if n > count]
        if over:
            raise ValueError(f"sizes {over} exceed the {count} card(s) of "
                             f"this machine: one NCCL rank per card")
    rows = []
    for n in sizes:
        print(f"== n_devices={n} ==", flush=True)
        rec = run_size(n, a.device)
        print(rec["extras"], flush=True)
        print(rec["line"], flush=True)
        rows.append(rec)
    print("\n| D | send_cap/dest | a2a fwd MB/dev/step | n_alive | "
          "events | dPSNR vs 1dev | parity |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['n_devices']} | {r.get('send_cap')} | "
              f"{r.get('a2a_fwd_mb_dev_step')} | {r.get('n_alive')} | "
              f"{r.get('events')} | {r.get('dpsnr')} | "
              f"{'ok' if r['ok'] else 'FAILED'} |")
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {a.out}")
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
