"""Training on one GPU, or on several under torchrun: the port's
counterpart of scripts/train.py.

The flag names are the JAX script's. Run from the repository root:

    python -m grendel_tpu_torch.scripts.train -s <scene_dir> -m out/run1 --eval --bsz 4
    python -m grendel_tpu_torch.scripts.train --synthetic_structured \\
        --synthetic_cams 10 --llffhold 5 --iterations 300 --bsz 2
    torchrun --nproc_per_node 4 -m grendel_tpu_torch.scripts.train \\
        -s <scene_dir> -m out/run4 --bsz 4

The run goes to the card unless ``--device cpu`` is given. Under torchrun
(``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set) every process joins one
process group, NCCL with rank r on card ``cuda:{LOCAL_RANK}``, or gloo on
the CPU with ``--device cpu``, and trains its share with the multi-rank
loop (engine/trainer_dist.py); ``--n_devices`` must then be the world
size (-1, the default, takes it). Each rank logs to
``python_ws={world}_rk={rank}.log``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="3DGS training on one or more "
                                "GPUs")
    # the model
    p.add_argument("--source_path", "-s", type=str, default="")
    p.add_argument("--model_path", "-m", type=str, default="")
    p.add_argument("--images", "-i", type=str, default="images")
    p.add_argument("--resolution", "-r", type=float, default=-1,
                   help="GT downscale: 1/2/4/8 divider, -1 auto (cap width "
                        "at 1600), other = target width")
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--llffhold", type=int, default=8)
    # the optimizer and the densify schedule
    p.add_argument("--iterations", type=int, default=30_000)
    p.add_argument("--position_lr_init", type=float, default=0.00016)
    p.add_argument("--position_lr_final", type=float, default=0.0000016)
    p.add_argument("--position_lr_delay_mult", type=float, default=0.01)
    p.add_argument("--position_lr_max_steps", type=int, default=30_000)
    p.add_argument("--feature_lr", type=float, default=0.0025)
    p.add_argument("--opacity_lr", type=float, default=0.05)
    p.add_argument("--scaling_lr", type=float, default=0.005)
    p.add_argument("--rotation_lr", type=float, default=0.001)
    p.add_argument("--lambda_dssim", type=float, default=0.2)
    p.add_argument("--percent_dense", type=float, default=0.01)
    p.add_argument("--densification_interval", type=int, default=100)
    p.add_argument("--opacity_reset_interval", type=int, default=3000)
    p.add_argument("--opacity_reset_until_iter", type=int, default=-1)
    p.add_argument("--densify_from_iter", type=int, default=500)
    p.add_argument("--densify_until_iter", type=int, default=15_000)
    p.add_argument("--densify_grad_threshold", type=float, default=0.0002)
    p.add_argument("--disable_auto_densification", action="store_true")
    p.add_argument("--min_opacity", type=float, default=0.005)
    p.add_argument("--lr_scale_mode", type=str, default="sqrt",
                   choices=["linear", "sqrt", "accumu"])
    p.add_argument("--lr_scale_loss", type=float, default=1.0)
    p.add_argument("--lr_scale_pos_and_scale", type=float, default=1.0)
    p.add_argument("--random_background", action="store_true")
    p.add_argument("--densify_memory_limit_percentage", type=float,
                   default=0.9)
    # the batch and its distribution over the ranks
    p.add_argument("--bsz", type=int, default=1)
    p.add_argument("--n_devices", type=int, default=-1,
                   help="the world size under torchrun; -1 = the world")
    p.add_argument("--gaussians_distribution", type=int, default=1)
    p.add_argument("--image_distribution", type=int, default=1)
    p.add_argument("--image_distribution_mode", type=str, default="final",
                   help="parsed for the reference's command lines; only "
                        "'final' exists")
    p.add_argument("--heuristic_decay", type=float, default=0.0)
    p.add_argument("--no_heuristics_update", action="store_true")
    p.add_argument("--adjust_strategy_warmp_iterations", type=int,
                   default=-1, help="-1 = one epoch")
    p.add_argument("--border_divpos_coeff", type=float, default=1.0,
                   help="snap division points within this many tile rows "
                        "of an image boundary to the boundary")
    p.add_argument("--redistribute_gaussians_mode", type=str,
                   default="random_redistribute",
                   choices=["random_redistribute", "no_redistribute"])
    p.add_argument("--redistribute_gaussians_frequency", type=int, default=10)
    p.add_argument("--redistribute_gaussians_threshold", type=float,
                   default=1.1)
    p.add_argument("--distributed_save", type=int, default=1,
                   help="per-rank PLY and checkpoint files of a sharded "
                        "model")
    p.add_argument("--distributed_dataset_storage", type=int, default=1,
                   help="under torchrun, each rank decodes only its "
                        "stride of the dataset at load (uid %% world == "
                        "rank) and the rest on demand; off where the "
                        "dataset is preloaded")
    p.add_argument("--sync_grad_mode", type=str, default="dense",
                   choices=["dense", "sparse", "fused_dense", "fused_sparse"],
                   help="parsed; the replicated gradients are one "
                        "all-reduce")
    p.add_argument("--local_sampling", action="store_true")
    p.add_argument("--preload_dataset_to_gpu", action="store_true",
                   help="the training ground truth on the device, gathered "
                        "there each step; switches local_sampling and "
                        "distributed storage off. Otherwise it stays on the "
                        "host and each step uploads its batch's (each "
                        "rank's rows')")
    p.add_argument("--preload_dataset_to_gpu_threshold", type=int, default=10,
                   help="GB; datasets smaller than this are preloaded as if "
                        "by --preload_dataset_to_gpu (<=0: never)")
    p.add_argument("--save_strategy_history", action="store_true")
    p.add_argument("--grad_normalization_mode", type=str, default="none",
                   choices=["none", "divide_by_visible_count",
                            "multiply_by_visible_count",
                            "square_multiply_by_visible_count"])
    # the render
    p.add_argument("--tile", type=str, default=None,
                   help="WxH tile geometry (default 32x16)")
    # logging, timing, checkpoints
    p.add_argument("--end2end_time", type=int, default=1,
                   help="log train-only wall time excluding eval/save")
    p.add_argument("--check_gpu_memory", action="store_true")
    p.add_argument("--check_cpu_memory", action="store_true")
    p.add_argument("--log_memory_summary", action="store_true",
                   help="the card's largest reservation in the memory line")
    p.add_argument("--nsys_profile", action="store_true",
                   help="a torch.profiler trace of about 10 steps into "
                        "<model_path>/trace")
    p.add_argument("--enable_timer", action="store_true",
                   help="per-stage times logged every log_interval: on the "
                        "card the stream's time between CUDA events, so a "
                        "host stage's is the stream's queue, not the host's "
                        "work")
    p.add_argument("--zhx_time", action="store_true",
                   help="the reference's alias of --enable_timer")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--zhx_debug", action="store_true",
                   help="the reference's alias of --debug")
    p.add_argument("--detect_anomaly", action="store_true",
                   help="autograd's anomaly mode, and a raise on a "
                        "non-finite loss")
    p.add_argument("--multiprocesses_image_loading", type=int, default=1,
                   help="0 = one thread decodes the ground truth")
    p.add_argument("--time_image_loading", action="store_true")
    p.add_argument("--quiet", "-q", action="store_true")
    p.add_argument("--log_folder", type=str, default="",
                   help="log file directory (default: model_path)")
    p.add_argument("--log_interval", type=int, default=250)
    p.add_argument("--test_iterations", nargs="+", type=int,
                   default=[7_000, 30_000])
    p.add_argument("--save_iterations", nargs="+", type=int,
                   default=[7_000, 30_000])
    p.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    p.add_argument("--start_checkpoint", type=str, default=None)
    p.add_argument("--auto_start_checkpoint", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stop_update_param", action="store_true")
    p.add_argument("--drop_initial_3dgs_p", type=float, default=0.0)
    p.add_argument("--drop_duplicate_gaussians_coeff", type=float,
                   default=1.0)
    p.add_argument("--num_train_cameras", type=int, default=-1)
    p.add_argument("--num_test_cameras", type=int, default=-1)
    # the in-repo scenes
    p.add_argument("--synthetic", action="store_true",
                   help="train on a generated random Gaussian scene")
    p.add_argument("--synthetic_size", type=str, default="160x120",
                   help="WxH of the synthetic scenes")
    p.add_argument("--synthetic_gaussians", type=int, default=400)
    p.add_argument("--synthetic_points", type=int, default=300)
    p.add_argument("--synthetic_structured", action="store_true",
                   help="train on the raytraced structured scene (hemisphere "
                        "rig, every llffhold-th view held out)")
    p.add_argument("--synthetic_cams", type=int, default=72,
                   help="cameras on the structured hemisphere rig")
    p.add_argument("--device", type=str, default="cuda")
    return p


def args_to_config(a):
    from ..config import TrainConfig

    cfg = TrainConfig()
    m = cfg.model
    m.sh_degree, m.source_path, m.model_path = (a.sh_degree, a.source_path,
                                                a.model_path)
    m.images, m.white_background, m.eval = a.images, a.white_background, a.eval
    m.llffhold, m.resolution = a.llffhold, a.resolution
    for f in ("iterations", "position_lr_init", "position_lr_final",
              "position_lr_delay_mult", "position_lr_max_steps", "feature_lr",
              "opacity_lr", "scaling_lr", "rotation_lr", "lambda_dssim",
              "percent_dense", "densification_interval",
              "opacity_reset_interval", "opacity_reset_until_iter",
              "densify_from_iter", "densify_until_iter",
              "densify_grad_threshold", "disable_auto_densification",
              "min_opacity", "lr_scale_mode", "lr_scale_loss",
              "random_background", "densify_memory_limit_percentage",
              "lr_scale_pos_and_scale"):
        setattr(cfg.opt, f, getattr(a, f))
    if a.tile:
        tw, th = (int(x) for x in a.tile.split("x"))
        cfg.pipeline.tile_w, cfg.pipeline.tile_h = tw, th
    d = cfg.dist
    d.bsz, d.local_sampling = a.bsz, a.local_sampling
    d.save_strategy_history = a.save_strategy_history
    d.grad_normalization_mode = a.grad_normalization_mode
    d.gaussians_distribution = bool(a.gaussians_distribution)
    d.image_distribution = bool(a.image_distribution)
    d.distributed_save = bool(a.distributed_save)
    d.distributed_dataset_storage = bool(a.distributed_dataset_storage)
    d.preload_dataset_to_gpu = a.preload_dataset_to_gpu
    d.preload_dataset_to_gpu_threshold = a.preload_dataset_to_gpu_threshold
    for f in ("image_distribution_mode", "heuristic_decay",
              "no_heuristics_update", "adjust_strategy_warmp_iterations",
              "border_divpos_coeff", "redistribute_gaussians_mode",
              "redistribute_gaussians_frequency",
              "redistribute_gaussians_threshold", "sync_grad_mode"):
        setattr(d, f, getattr(a, f))
    d.num_train_cameras, d.num_test_cameras = (a.num_train_cameras,
                                               a.num_test_cameras)
    cfg.end2end_time = bool(a.end2end_time)
    cfg.check_gpu_memory, cfg.check_cpu_memory = (a.check_gpu_memory,
                                                  a.check_cpu_memory)
    cfg.enable_timer, cfg.quiet = a.enable_timer or a.zhx_time, a.quiet
    cfg.log_memory_summary, cfg.nsys_profile = (a.log_memory_summary,
                                                a.nsys_profile)
    cfg.pipeline.debug = a.debug or a.zhx_debug
    cfg.log_folder, cfg.log_interval = a.log_folder, a.log_interval
    cfg.test_iterations = list(a.test_iterations)
    cfg.save_iterations = list(a.save_iterations)
    cfg.checkpoint_iterations = list(a.checkpoint_iterations)
    cfg.start_checkpoint = a.start_checkpoint
    cfg.auto_start_checkpoint = a.auto_start_checkpoint
    cfg.seed = a.seed
    cfg.stop_update_param = a.stop_update_param
    cfg.drop_initial_3dgs_p = a.drop_initial_3dgs_p
    cfg.drop_duplicate_gaussians_coeff = a.drop_duplicate_gaussians_coeff
    return cfg.finalize()


def make_decode_mask(cfg, world: int, rank: int):
    """The ground truth this process decodes at load under
    ``--distributed_dataset_storage`` (the port's counterpart of the JAX
    script's ``make_decode_mask``): the cameras with ``uid % world ==
    rank``; every other camera decodes on demand (``Camera.gt``). None,
    decode everything, when storage is off or the world has one rank.

    The JAX script has two rules. With ``local_sampling`` a process keeps
    the cameras of its devices' groups, ``uid % D`` in the mesh positions
    of its devices; otherwise its stride over processes, ``uid % P ==
    process_index``. The port runs one process per device, so D = P =
    world and a process's one position is its rank: both rules keep
    ``uid % world == rank``. (Scene numbers its cameras by position, so a
    camera's uid is the mask's index.)"""
    if not cfg.dist.distributed_dataset_storage or world == 1:
        return None
    return lambda i, ci: i % world == rank


def make_scene(a, device, decode_mask=None):
    """The scene the flags name: a structured or random synthetic scene, or
    a scene directory (COLMAP, Blender or MatrixCity), whose ground truth
    decodes at load where ``decode_mask`` (:func:`make_decode_mask`) says
    so."""
    from .. import testing

    if a.synthetic_structured or a.synthetic:
        w, h = (int(x) for x in a.synthetic_size.split("x"))
    if a.synthetic_structured:
        t0 = time.time()
        scene = testing.StructuredSyntheticScene(
            width=w, height=h, n_cams=a.synthetic_cams, llffhold=a.llffhold,
            n_init_points=a.synthetic_points, seed=a.seed)
        print(f"[structured] raytraced {a.synthetic_cams} GT views at {w}x{h}"
              f" in {time.time() - t0:.1f}s ({len(scene.train_cameras)} train"
              f" / {len(scene.test_cameras)} held-out)", flush=True)
        return scene
    if a.synthetic:
        return testing.SyntheticScene(
            width=w, height=h, sh_degree=min(a.sh_degree, 1), seed=a.seed,
            n_gaussians=a.synthetic_gaussians,
            n_init_points=a.synthetic_points, device=device)
    from ..data import Scene

    t_load = time.time()
    scene = Scene(a.source_path, images=a.images, eval_split=a.eval,
                  llffhold=a.llffhold, white_background=a.white_background,
                  num_train=a.num_train_cameras, num_test=a.num_test_cameras,
                  seed=a.seed, resolution=a.resolution,
                  decode_mask=decode_mask, device=device,
                  decode_workers=8 if a.multiprocesses_image_loading else 1)
    if a.time_image_loading:
        print(f"[timing] scene + GT decode: {time.time() - t_load:.2f}s",
              flush=True)
    stored = sum(c.gt_image_u8 is not None for c in scene.train_cameras)
    if stored < len(scene.train_cameras):
        print(f"[storage] decoded {stored}/{len(scene.train_cameras)} train "
              f"GT images (--distributed_dataset_storage; the rest decode "
              f"on demand)", flush=True)
    return scene


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    if not (a.synthetic or a.synthetic_structured) and not a.source_path:
        raise SystemExit("need --source_path (or --synthetic[_structured])")
    launched = "WORLD_SIZE" in os.environ        # by torchrun
    world = int(os.environ.get("WORLD_SIZE", 1))
    rank = int(os.environ.get("RANK", 0))
    if a.n_devices not in (-1, world):
        raise SystemExit(
            f"--n_devices {a.n_devices} but the world has {world} "
            f"process(es): start one process per device with torchrun "
            f"--nproc_per_node {a.n_devices}")
    if not a.model_path:
        a.model_path = os.path.join(
            "output",
            "synthetic_structured" if a.synthetic_structured else
            "synthetic" if a.synthetic else
            os.path.basename(os.path.normpath(a.source_path)))

    import torch

    from ..device import resolve_device
    from ..engine.checkpoint import find_latest_checkpoint
    from ..engine.trainer_dist import make_trainer
    from ..parallel import comm

    cfg = args_to_config(a)
    device = resolve_device(a.device)
    if launched and device.type == "cuda":
        device = resolve_device(f"cuda:{os.environ.get('LOCAL_RANK', 0)}")
    os.makedirs(cfg.model.model_path, exist_ok=True)
    if rank == 0:
        with open(os.path.join(cfg.model.model_path, "args.json"), "w") as f:
            json.dump(vars(a), f, indent=2)
    if cfg.auto_start_checkpoint and cfg.start_checkpoint is None:
        cfg.start_checkpoint = find_latest_checkpoint(cfg.model.model_path)
    if launched:
        comm.init_group(device)
    try:
        scene = make_scene(a, device, make_decode_mask(cfg, world, rank))
        os.makedirs(cfg.log_folder, exist_ok=True)
        with open(os.path.join(cfg.log_folder,
                               f"python_ws={world}_rk={rank}.log"),
                  "a") as log_file:
            trainer = make_trainer(cfg, scene, device=device,
                                   log_file=log_file)
            # the JAX script's jax_debug_nans: the loop raises on a
            # non-finite loss under anomaly mode
            with torch.autograd.set_detect_anomaly(a.detect_anomaly):
                trainer.train()
            trainer.save_model(int(trainer.state.iteration))
    finally:
        comm.destroy_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
