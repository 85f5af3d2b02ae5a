"""Render a trained model's views to PNG files: the port's counterpart of
scripts/render.py.

    python -m grendel_tpu_torch.scripts.render -m out/run1 [-s <scene_dir>] [--iteration N]
    torchrun --nproc_per_node 4 -m grendel_tpu_torch.scripts.render -m out/run1

Loads ``<model_path>/point_cloud/iteration_N`` (``point_cloud.ply`` or the
per-rank ``point_cloud_rk{r}_ws{w}.ply`` files; ``--iteration -1``, the
default, takes the newest) and writes the training and held-out views to
``<model_path>/{train,test}/ours_N/{renders,gt}/%05d.png``, each image
clipped to [0, 1] and rounded as ``(x * 255 + 0.5)`` to uint8. The scene
comes from ``--source_path``, or from the run's saved ``args.json``: its
source path, or the synthetic or structured scene it trained on, rebuilt
from the same arguments. Batches of ``--bsz`` views; the last one is
padded with its last view.

Alone, the process renders each batch with engine/render.py
``render_batch`` (kernels K1 and K3 on the card). Under torchrun each rank
holds a contiguous share of the model and renders the rows an even
division gives it with parallel/sharded.py ``DistributedTrainer.render``;
rank 0 writes the files. The tile lists take exactly the entries there
are, and the exchange's buckets every (Gaussian, camera) pair of a shard,
so no batch drops any. (The JAX tool sizes its buckets for one camera and
drops Gaussians of the later cameras of a batch when ``--bsz`` > 1.) Runs on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

TILE = 16            # the JAX render tool's tile geometry and depth cutoff
MAX_PER_TILE = 2048


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Render a trained model's views")
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--source_path", "-s", default=None)
    p.add_argument("--images", "-i", default="images")
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--eval", action="store_true", default=True)
    p.add_argument("--llffhold", type=int, default=8)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--bsz", type=int, default=1)
    p.add_argument("--resolution", "-r", type=float, default=None,
                   help="GT downscale (defaults to the training run's)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def merge_saved_args(a) -> dict | None:
    """Fill unset arguments from the run's ``args.json`` (the reference's
    get_combined_args); returns the saved arguments of a synthetic or
    structured run when no source path is known, else None."""
    args_json = os.path.join(a.model_path, "args.json")
    saved = None
    if os.path.exists(args_json):
        with open(args_json) as f:
            saved = json.load(f)
    if a.source_path is None and saved is not None:
        a.source_path = saved.get("source_path")
        a.sh_degree = saved.get("sh_degree", a.sh_degree)
        a.white_background = saved.get("white_background",
                                       a.white_background)
        a.llffhold = saved.get("llffhold", a.llffhold)
        if a.resolution is None:
            a.resolution = saved.get("resolution", -1)
    if a.resolution is None:
        a.resolution = -1
    synthetic = None
    if (not a.source_path and saved is not None
            and (saved.get("synthetic") or saved.get("synthetic_structured"))):
        synthetic = saved
    if not a.source_path and synthetic is None:
        raise SystemExit("need --source_path (not found in saved args)")
    return synthetic


def make_scene(a, synthetic, device):
    from .. import testing

    if synthetic is not None:
        w, h = (int(x) for x in synthetic["synthetic_size"].split("x"))
        if synthetic.get("synthetic_structured"):
            return testing.StructuredSyntheticScene(
                width=w, height=h, n_cams=synthetic.get("synthetic_cams", 72),
                llffhold=synthetic.get("llffhold", 8),
                n_init_points=synthetic.get("synthetic_points", 300),
                seed=synthetic.get("seed", 0))
        return testing.SyntheticScene(
            width=w, height=h, sh_degree=min(synthetic.get("sh_degree", 3), 1),
            seed=synthetic.get("seed", 0),
            n_gaussians=synthetic.get("synthetic_gaussians", 400),
            n_init_points=synthetic.get("synthetic_points", 300),
            device=device)
    from ..data import Scene

    return Scene(a.source_path, images=a.images, eval_split=a.eval,
                 llffhold=a.llffhold, white_background=a.white_background,
                 resolution=a.resolution, device=device)


def newest_iteration(model_path: str) -> int:
    pc_root = os.path.join(model_path, "point_cloud")
    return max(int(d.split("_")[1]) for d in os.listdir(pc_root)
               if d.startswith("iteration_"))


class Renderer:
    """Renders batches of cameras: ``render_batch`` in one process, the
    ranks' rows under a process group."""

    def __init__(self, ply_dir: str, a, img_h: int, img_w: int, device):
        import torch.distributed as dist

        from ..engine.gaussian_io import load_ply
        from ..engine.render import RenderConfig
        from ..models.gaussian_model import round_capacity

        self.device, self.sh_degree = device, a.sh_degree
        self.bg = torch.tensor([1.0, 1.0, 1.0] if a.white_background
                               else [0.0, 0.0, 0.0], device=device)
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        if self.world == 1:
            self.params, self.alive = load_ply(ply_dir, device=device)
            self.cfg = RenderConfig(img_h=img_h, img_w=img_w, tile_w=TILE,
                                    tile_h=TILE, isect_capacity=0,
                                    max_per_tile=MAX_PER_TILE)
            return
        from ..engine.train import XyzLrSchedule
        from ..models.optimizer import scaled_lrs
        from ..parallel.division import divide_rows
        from ..parallel.sharded import DistributedTrainer, ParallelConfig

        rank = dist.get_rank()
        _, alive = load_ply(ply_dir, device="cpu")
        n_local = round_capacity(max(-(-int(alive.sum()) // self.world), 1))
        self.params, self.alive = load_ply(ply_dir, capacity=n_local,
                                           shard=(rank, self.world),
                                           device=device)
        # a bucket holds every (Gaussian, camera) pair of a shard: none is
        # dropped
        cfg = ParallelConfig(n_devices=self.world, bsz=a.bsz, img_h=img_h,
                             img_w=img_w, tile_w=TILE, tile_h=TILE,
                             send_cap=a.bsz * n_local, isect_capacity=0,
                             max_per_tile=MAX_PER_TILE).resolved(n_local)
        lrs, _ = scaled_lrs(0.0025, 0.05, 0.005, 0.001, bsz=a.bsz)
        self.trainer = DistributedTrainer(
            cfg, a.sh_degree, lambda_dssim=0.2, lrs=lrs,
            xyz_sched=XyzLrSchedule(1.6e-4, 1.6e-6, 0.01, 30000))
        self.pos = torch.as_tensor(divide_rows(
            np.ones(cfg.total_rows), self.world, cfg.n_row_slots),
            device=device)

    @torch.no_grad()
    def __call__(self, cams) -> torch.Tensor:
        """(B, 3, H, W) images of a batch of cameras."""
        from ..cameras import batch_camera_arrays
        from ..engine.render import render_batch

        arrays = batch_camera_arrays(cams, self.device)
        if self.world == 1:
            return render_batch(self.params, self.alive, arrays,
                                self.sh_degree, self.cfg, bg=self.bg)[0]
        return self.trainer.render(self.params, self.alive, arrays, self.pos,
                                   self.bg)


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    synthetic = merge_saved_args(a)

    from ..device import resolve_device
    from ..parallel import comm
    from ..utils.png import write_png

    launched = "WORLD_SIZE" in os.environ        # by torchrun
    rank = int(os.environ.get("RANK", 0))
    device = resolve_device(a.device)
    if launched and device.type == "cuda":
        device = resolve_device(f"cuda:{os.environ.get('LOCAL_RANK', 0)}")
    if launched:
        comm.init_group(device)
    try:
        it = a.iteration if a.iteration != -1 else newest_iteration(
            a.model_path)
        ply_dir = os.path.join(a.model_path, "point_cloud", f"iteration_{it}")
        scene = make_scene(a, synthetic, device)
        cam0 = scene.train_cameras[0]
        render = Renderer(ply_dir, a, cam0.height, cam0.width, device)

        sets = []
        if not a.skip_train:
            sets.append(("train", scene.train_cameras))
        if not a.skip_test and scene.test_cameras:
            sets.append(("test", scene.test_cameras))
        for name, cams in sets:
            out = os.path.join(a.model_path, name, f"ours_{it}")
            rdir, gdir = os.path.join(out, "renders"), os.path.join(out, "gt")
            if rank == 0:
                os.makedirs(rdir, exist_ok=True)
                os.makedirs(gdir, exist_ok=True)
            for i in range(0, len(cams), a.bsz):
                batch = cams[i:i + a.bsz]
                imgs = render(batch + [batch[-1]] * (a.bsz - len(batch)))
                if rank != 0:
                    continue
                imgs = torch.clamp(imgs, 0.0, 1.0).cpu().numpy()
                for b, cam in enumerate(batch):
                    write_png(os.path.join(rdir, f"{i + b:05d}.png"),
                              (imgs[b].transpose(1, 2, 0) * 255 + 0.5)
                              .astype(np.uint8))
                    gt = cam.gt()     # decodes a lazily stored camera
                    if gt is not None:
                        write_png(os.path.join(gdir, f"{i + b:05d}.png"),
                                  gt.transpose(1, 2, 0))
            if rank == 0:
                print(f"rendered {len(cams)} {name} views -> {rdir}",
                      flush=True)
    finally:
        comm.destroy_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
