"""Peak device memory of the simulated multi-rank step of whichever tree
of the port is on the path.

    PYTHONPATH=<tree> python3 grendel_tpu_torch/scripts/sim_peak.py

Runs ``testing.simulate_distributed`` (every rank's pack, exchange, owned
rows, loss and one backward, in one process) on the garden
(``testing.garden_training``: 200,000 live Gaussians, bsz 2 at 1296x840)
at D=2, split at the camera border, and at D=4 on an uneven division, the
two cases of ``chip_smoke.py`` phase 10, and prints for each the bytes
that ``torch.cuda.max_memory_allocated`` rose above what was held before
the step, and the step's loss, as one JSON line. The script uses only
``testing`` and ``parallel`` names that every tree of the port since the
distributed step has, so that two trees (a parent and a change) can be
measured one after the other on one card. It puts the tree given by
``PYTHONPATH`` first on the path, before its own directory.
"""

import json
import os
import sys


def main(argv=None) -> int:
    if os.path.dirname(os.path.abspath(sys.argv[0])) == sys.path[0]:
        sys.path.pop(0)    # this directory's train.py, render.py, ...
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sim_peak.py needs a CUDA card")
    import grendel_tpu_torch
    from grendel_tpu_torch.parallel.division import divide_rows, pack_gt_rows
    from grendel_tpu_torch.parallel.sharded import ParallelConfig
    from grendel_tpu_torch.testing import (garden_scene, garden_training,
                                           simulate_distributed)

    dev = torch.device("cuda")
    tr = garden_training(seed=0, device=dev)
    cameras = garden_scene(seed=0, device=dev).cameras
    rcfg, bsz = tr.cfg, tr.bsz
    capacity = tr.state.alive.shape[0]
    gt_np = list(tr.gt_u8.cpu().numpy())
    kw = dict(bsz=bsz, img_h=rcfg.img_h, img_w=rcfg.img_w,
              tile_w=rcfg.tile_w, tile_h=rcfg.tile_h,
              isect_capacity=bsz * rcfg.isect_capacity,
              blend_capacity=bsz * rcfg.blend_cap,
              max_per_tile=rcfg.max_per_tile)
    tiles_y = ParallelConfig(n_devices=1, **kw).tiles_y
    heavy = np.ones(bsz * tiles_y)
    heavy[:tiles_y // 3] = 8.0
    cases = {2: dict(n_row_slots=tiles_y, pos=[0, tiles_y, 2 * tiles_y]),
             4: dict(n_row_slots=2 * tiles_y, pos=None)}
    out = {"package": os.path.dirname(grendel_tpu_torch.__file__)}
    for d_count, case in cases.items():
        cfg = ParallelConfig(
            n_devices=d_count, n_row_slots=case["n_row_slots"],
            send_cap=bsz * capacity // d_count, **kw
        ).resolved(capacity // d_count)
        pos_np = (divide_rows(heavy, d_count, cfg.n_row_slots)
                  if case["pos"] is None
                  else np.array(case["pos"], np.int32))
        gt_rows = torch.as_tensor(pack_gt_rows(
            cameras, pos_np, d_count, cfg.n_row_slots, cfg.tile_h,
            cfg.img_h, cfg.img_w, gt_override=gt_np), device=dev)
        pos = torch.as_tensor(pos_np, device=dev)
        runs = []
        for _ in range(2):   # the first also builds the kernels
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            sim = simulate_distributed(
                tr.state.params, tr.state.alive, tr.cams, gt_rows, pos,
                tr.bg, cfg, tr.sh_degree, tr.lambda_dssim)
            torch.cuda.synchronize()
            runs.append(torch.cuda.max_memory_allocated() - base)
            loss = float(sim.loss)
            del sim
        out[f"D{d_count}"] = {"peak_bytes": runs[-1], "peak_bytes_first": runs[0],
                              "base_bytes": base, "loss": loss,
                              "division": pos_np.tolist()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
