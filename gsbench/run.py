"""Run one cell of the benchmark of ``grendel_tpu_torch`` once.

    python3 gsbench/run.py --workload garden4k-train --seed 7 --seconds 10 --trace 0

from the repository's root, on a machine with a CUDA card. Set-up builds
the cell from ``--seed`` (weights and ground truth on the card, kernels
built or loaded, every shape warmed up), the window measures for
``--seconds``, and the reference then checks what the window produced.
With ``--trace 1`` a profiled window gives the per-layer metrics instead
of the end-to-end ones. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(with ``--trace 1`` also ``breakdown``) and, last, ``limits``: each number
compared with its limit, which standard error repeats as its last lines.

``--calibrate N`` instead reads the compared numbers of N seeds from
``--seed`` on, and ``--control N`` those of the control (the reference in
bfloat16 in the program's place) on N seeds: the readings each limit is
set from. Neither prints a result line.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gsbench import harness  # noqa: E402
from gsbench.reference.compare import judge  # noqa: E402


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t0: float, base=harness.HERE) -> dict:
    """One run of ``cell``; returns the result line as a dict."""
    import torch

    bench = harness.load_benchmark(base)
    wl = harness.load_workload(cell, base)
    cfg = harness.load_config(wl["config"], base)
    entry = harness.load_entry(wl["entry"])
    c = entry.Cell(cfg, wl, seed, device)
    setup_s = time.perf_counter() - t0
    out = {}
    if trace:
        ev = c.traced()
        metrics = {}
        for m in harness.cell_metrics(bench, cell, "per_layer"):
            v = harness.load_metric(m["name"], base).read(ev)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = ev["breakdown"]
        dev_extra = {"busy_s": ev["busy_s"], "window_s": ev["window_s"]}
    else:
        e2e = dict(c.window(seconds), setup_s=setup_s)
        dev_extra = {}
    peak = c.peak_bytes()
    if not trace:
        e2e["peak_mem_gib"] = peak / 2 ** 30
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in harness.cell_metrics(bench, cell, "end_to_end")}
    attempted = c.attempted
    if getattr(c, "note", None):
        print(f"gsbench: {c.note}", file=sys.stderr)
    t_ref = time.perf_counter()
    numbers = c.finish()
    print(f"gsbench: set-up {setup_s:.3f} s, reference "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    ok, rows = judge(numbers, wl["limits"])
    failed = sum(1 for _, v, lim in rows if not (v is not None and v <= lim))
    on_card = device.type == "cuda"
    out.update(
        correct=ok, attempted=attempted, failed=failed, metrics=metrics,
        device=dict(platform="gpu" if on_card else device.type,
                    kind=torch.cuda.get_device_name(device) if on_card
                    else device.type, count=1, memory_peak_bytes=peak,
                    **dev_extra))
    out = {k: out[k] for k in ("correct", "attempted", "failed", "metrics",
                               "device", "breakdown") if k in out}
    out["limits"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--calibrate", type=int, default=0)
    ap.add_argument("--control", type=int, default=0)
    a = ap.parse_args(argv)

    import torch

    bench = harness.load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    chips = cells[a.workload]["chips"] if a.workload in cells else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gsbench: {a.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    # the loop is the host's one busy thread; idle pool threads only
    # contend with it
    torch.set_num_threads(1)
    if a.calibrate or a.control:
        wl = harness.load_workload(a.workload)
        entry = harness.load_entry(wl["entry"])
        cfg = harness.load_config(wl["config"])
        for kind, n in (("program", a.calibrate), ("control", a.control)):
            for s in range(a.seed, a.seed + n):
                nums = entry.readings(cfg, wl, s, dev, kind == "control")
                print(json.dumps({"reading": kind, "seed": s, **nums}),
                      flush=True)
        return 0
    res = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), dev, T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"gsbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in res["limits"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
