#!/usr/bin/env python
"""Log miner: tabulate training runs from their log files.

The port's own copy of scripts/analyze.py (the reference's analyze.py and
examples/*/analyze_results.py): parses each run's ``python_ws=*_rk=*.log``
files for end-to-end time, throughput, per-eval L1/PSNR, Gaussian counts,
densification rounds and ``--enable_timer`` stage times, and prints a
comparison table (optionally JSON). The port's training loop writes the
JAX loop's log lines, so one miner reads the runs of both packages; the
log line format is the observability API, as in the reference.

  python -m grendel_tpu_torch.scripts.analyze --model_paths output/run1 output/run2 [--json out.json]
"""

import argparse
import glob
import json
import os
import re


LINE = re.compile(r"^\[(\d+:\d+:\d+)\] (.*)$")
EVAL = re.compile(
    r"iter (\d+): eval (\w+): L1=([\d.]+) PSNR=([\d.]+)")
ITER = re.compile(
    r"iter (\d+): loss=([\d.]+) n3dgs=(\d+) xyz_lr=\S+ it/s=([\d.]+)")
DONE = re.compile(
    r"training done: (\d+) iters in ([\d.]+) min \(([\d.]+) it/s\)")
DENS = re.compile(
    r"iter (\d+): densify #(\d+) clone=(\d+) split=(\d+) prune=(\d+) "
    r"alive=(\d+)")
# --enable_timer stage lines ("timers: 50 step: 123.45 ms (x250, avg
# 0.49 ms); ..."), the analogue of the reference's gpu_time_*.log per-
# kernel stage timers mined by analyze_statistic.py:747-809
STAGE = re.compile(r"([\w+ ]+?): ([\d.]+) ms \(x(\d+), avg ([\d.]+) ms\)")


def analyze_run(model_path: str) -> dict:
    out = {
        "model_path": model_path,
        "evals": [],        # (iter, split, l1, psnr)
        "iters": [],        # (iter, loss, n3dgs, it_per_s)
        "densify": [],      # (iter, count, clone, split, prune, alive)
        "stages": {},       # key -> {"ms": total, "n": count}
        "end2end_min": None,
        "final_it_per_s": None,
        "final_n3dgs": None,
    }
    for log_path in sorted(glob.glob(
            os.path.join(model_path, "python_ws=*_rk=*.log"))):
        with open(log_path) as f:
            for raw in f:
                m = LINE.match(raw.strip())
                if not m:
                    continue
                msg = m.group(2)
                if (e := EVAL.search(msg)):
                    out["evals"].append((int(e.group(1)), e.group(2),
                                         float(e.group(3)), float(e.group(4))))
                elif (e := ITER.search(msg)):
                    out["iters"].append((int(e.group(1)), float(e.group(2)),
                                         int(e.group(3)), float(e.group(4))))
                elif (e := DENS.search(msg)):
                    out["densify"].append(tuple(int(g) for g in e.groups()))
                elif msg.startswith("timers: "):
                    for key, total, n, _avg in STAGE.findall(msg[8:]):
                        s = out["stages"].setdefault(
                            key.strip(), {"ms": 0.0, "n": 0})
                        s["ms"] += float(total)
                        s["n"] += int(n)
                elif (e := DONE.search(msg)):
                    out["end2end_min"] = float(e.group(2))
                    out["final_it_per_s"] = float(e.group(3))
    if out["iters"]:
        out["final_n3dgs"] = out["iters"][-1][2]
    # metrics.py results, if present
    for split in ("test", "train"):
        rp = os.path.join(model_path, f"results_{split}.json")
        if os.path.exists(rp):
            with open(rp) as f:
                out[f"results_{split}"] = json.load(f)
    return out


def print_stage_table(rows):
    """Per-stage time table across runs (analogue of the reference's
    per-kernel GPU time tables, analyze_statistic.py:747-809). Requires
    runs trained with --enable_timer."""
    for r in rows:
        if not r["stages"]:
            continue
        print(f"\n== stage times: {os.path.basename(r['model_path'])} ==")
        print(f"{'stage':24s} {'total(s)':>9s} {'calls':>7s} {'avg(ms)':>8s} "
              f"{'share':>6s}")
        total = sum(s["ms"] for s in r["stages"].values())
        for key in sorted(r["stages"]):
            s = r["stages"][key]
            print(f"{key:24s} {s['ms'] / 1e3:9.2f} {s['n']:7d} "
                  f"{s['ms'] / max(s['n'], 1):8.2f} "
                  f"{s['ms'] / max(total, 1e-9):6.1%}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_paths", "-m", nargs="+", required=True)
    p.add_argument("--json", type=str, default=None)
    p.add_argument("--stages", action="store_true",
                   help="print per-stage time tables (--enable_timer runs)")
    a = p.parse_args(argv)

    rows = [analyze_run(mp) for mp in a.model_paths]
    header = (f"{'run':40s} {'time(min)':>9s} {'it/s':>6s} {'n3dgs':>9s} "
              f"{'test PSNR':>9s} {'test L1':>8s}")
    print(header)
    print("-" * len(header))
    for r in rows:
        test_evals = [e for e in r["evals"] if e[1] == "test"]
        psnr = f"{test_evals[-1][3]:.3f}" if test_evals else "-"
        l1 = f"{test_evals[-1][2]:.5f}" if test_evals else "-"
        t = f"{r['end2end_min']:.2f}" if r["end2end_min"] else "-"
        ips = f"{r['final_it_per_s']:.2f}" if r["final_it_per_s"] else "-"
        n = str(r["final_n3dgs"]) if r["final_n3dgs"] else "-"
        print(f"{os.path.basename(r['model_path']):40s} {t:>9s} {ips:>6s} "
              f"{n:>9s} {psnr:>9s} {l1:>8s}")
    if a.stages:
        print_stage_table(rows)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(rows, f, indent=2)


if __name__ == "__main__":
    main()
