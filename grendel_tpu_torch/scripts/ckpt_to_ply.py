"""Turn a training checkpoint into the ``point_cloud/iteration_N`` PLY
that the render and metrics tools read: the port's counterpart of
scripts/ckpt_to_ply.py.

    python -m grendel_tpu_torch.scripts.ckpt_to_ply -m <model_path> [--iteration N]

Reads the checkpoint set ``<model_path>/checkpoints/N`` (the newest
without ``--iteration``), written by any number of ranks, as one model
and writes its live Gaussians to
``<model_path>/point_cloud/iteration_N/point_cloud.ply``. Host work only:
it runs on the CPU.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="Checkpoint to PLY")
    ap.add_argument("--model_path", "-m", required=True)
    ap.add_argument("--iteration", type=int, default=0,
                    help="checkpoint iteration (default: the newest)")
    a = ap.parse_args(argv)

    from ..engine.checkpoint import (find_latest_checkpoint,
                                     load_checkpoint_sharded)
    from ..engine.gaussian_io import save_ply

    if a.iteration:
        ckpt = os.path.join(a.model_path, "checkpoints", str(a.iteration))
    else:
        ckpt = find_latest_checkpoint(a.model_path)
    if not (ckpt and os.path.isdir(ckpt)):
        raise SystemExit(f"no checkpoint under {a.model_path}")
    state = load_checkpoint_sharded(ckpt, world_size=1, device="cpu")
    it = int(state.iteration)
    path = os.path.join(a.model_path, "point_cloud", f"iteration_{it}",
                        "point_cloud.ply")
    save_ply(path, state.params, state.alive)
    print(f"wrote {path}: {int(state.alive.sum())} gaussians at iteration "
          f"{it}")
    return path


if __name__ == "__main__":
    main()
