"""Small copies of the benchmark's cells for the CPU tests: the same files
and entries, at sizes the CPU's plain kernels run in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from gsbench import harness

TINY_CONFIG = {
    "mip360_garden_4k": {"width": 72, "height": 40, "n_live": 600,
                         "capacity": 1024, "extent": 1.2,
                         "log_scale": [-3.5, -2.0]},
    "tnt_truck_1k": {"resolution": 8, "n_points": 1500},
}
# the viewer's cell: its entry (entries/render_batch.py) is kept for a
# later viewer cell and is tested here, though BENCHMARK.json has no such
# cell now
VIEWER = {"name": "garden4k-render", "config": "mip360_garden_4k",
          "traffic": "viewer_orbit", "entry": "render_batch", "poses": 64,
          "distance": 5.0, "sampled": 3, "warmup": 3, "trace_frames": 64,
          "calibrate_s": 3.0,
          "limits": {"frame_max_err": 0.04, "frame_mean_err": 0.0005,
                     "tile_count_mismatch": 0.05, "radius_mismatch": 0.005}}
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]] + \
    [VIEWER["name"]]
TINY_WORKLOAD = {
    "garden4k-train": {"segment": 5, "trace_steps": 2},
    "garden4k-render": {"poses": 6, "sampled": 2, "warmup": 1,
                        "trace_frames": 2, "calibrate_s": 2.0},
    "truck1k-loop": {"start_images": 560, "segment_images": 48,
                     "chunk_steps": 3, "trace_steps": 2, "sync_steps": 1,
                     "warm_segments": 0},
}


def tiny_copy(tmp: Path) -> Path:
    """A copy of the benchmark's files under ``tmp`` with every cell cut
    to a CPU size; returns the copy's ``gsbench`` directory."""
    base = tmp / "gsbench"
    shutil.copytree(harness.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests",
                                                  "data"))
    shutil.copy(harness.repo_root() / "BENCHMARK.json", tmp)
    (base / "workloads" / "garden4k-render.json").write_text(
        json.dumps(VIEWER))
    for kind, table in (("configs", TINY_CONFIG),
                        ("workloads", TINY_WORKLOAD)):
        for name, over in table.items():
            p = base / kind / f"{name}.json"
            if p.exists():
                d = json.loads(p.read_text())
                d.update(over)
                p.write_text(json.dumps(d, indent=1))
    _truck_bank(base)
    return base


def _truck_bank(base: Path) -> None:
    """The truck views' sha256 at the tiny copy's size, from PIL's decode
    and bilinear resize (the decode the program's is held to)."""
    import hashlib

    import numpy as np
    from PIL import Image

    cfg_path = base / "configs" / "tnt_truck_1k.json"
    cfg = json.loads(cfg_path.read_text())
    w0, h0 = cfg["image_size"]
    size = (int(w0 / cfg["resolution"]), int(h0 / cfg["resolution"]))
    bank = {"sha256": {}, "size": list(size)}
    for p in sorted((harness.HERE / cfg["images"]).glob("*.jpg")):
        with Image.open(p) as im:
            arr = np.asarray(im.resize(size, Image.BILINEAR))
        bank["sha256"][p.name] = hashlib.sha256(np.ascontiguousarray(
            arr.transpose(2, 0, 1)).tobytes()).hexdigest()
    (base / "truck_sha256.json").write_text(json.dumps(bank))
    cfg["ground_truth"] = str(base / "truck_sha256.json")
    cfg_path.write_text(json.dumps(cfg, indent=1))
