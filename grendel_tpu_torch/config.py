"""Configuration dataclasses for training / rendering.

The port's own copy of grendel_tpu/config.py (a jax-free module, copied
rather than imported so the port never imports the JAX package): the
reference's argparse ParamGroups (ModelParams, PipelineParams,
OptimizationParams, DistributionParams, DebugParams) as plain dataclasses,
with the same fields and defaults, so a configuration reads the same in
both packages. The training step takes its learning rates and loss weight
from ``OptimizationConfig``.

Fields marked "(tpu)" are the JAX package's static-shape additions
(padded capacities, tile-buffer capacities, mesh shape); they are kept so
the two packages share one configuration.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class ModelConfig:
    """Scene/model-level options (ref: ModelParams, arguments/__init__.py:85-98)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: float = -1
    white_background: bool = False
    eval: bool = False
    llffhold: int = 8


@dataclasses.dataclass
class PipelineConfig:
    """Render pipeline options (ref: PipelineParams + tile constants)."""

    # Tile size. The reference hardwires 16x16 (BLOCK_X/Y,
    # utils/general_utils.py:78-79); on TPU the flattened tile is the VPU
    # vector axis, so any 128-multiple pixel count works. Default 32x16
    # (512 px = 4 sublanes x 128 lanes): measured round 4 at garden scale,
    # 512-px tiles cut duplicated isect entries ~1.45x and buy ~11% step
    # throughput over 16x16; 1024-px tiles give it back (longer per-tile
    # walks) and 2048-px exceeds the kernel's scoped vmem. tile_h stays 16
    # so the row-based load balancer keeps its granularity.
    tile_w: int = 32
    tile_h: int = 16
    # (tpu) static capacities for the isect entry list / per-tile walk.
    isect_capacity_factor: float = 8.0   # initial guess: capacity = factor * N until telemetry sizes it
    # per-tile blend depth cutoff. -1 = auto: scale with tile area so the
    # per-PIXEL budget stays constant at 4 entries/px (1024 per 256-px tile,
    # the reference 16x16 norm) no matter what --tile selects — the round-4
    # bsz x tile sweep was measured at this constant budget, and a fixed
    # cutoff would silently halve the budget at the 512-px default tile.
    max_per_tile: int = -1
    chunk: int = 64                      # gaussians blended per scan step
    # rasterizer backend: "auto" = pallas on TPU, jax elsewhere (the two
    # backends mirror the reference's default/gsplat backend pair)
    backend: str = "auto"
    debug: bool = False


@dataclasses.dataclass
class OptimizationConfig:
    """Optimizer + densification schedule (ref: OptimizationParams,
    arguments/__init__.py:107-133)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    lr_scale_loss: float = 1.0
    lr_scale_pos_and_scale: float = 1.0
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    densify_memory_limit_percentage: float = 0.9
    disable_auto_densification: bool = False
    opacity_reset_until_iter: int = -1   # -1 -> densify_until_iter + bsz (init fixup)
    random_background: bool = False
    min_opacity: float = 0.005
    lr_scale_mode: str = "sqrt"          # "linear" | "sqrt" | "accumu"
    adam_eps: float = 1e-15
    adam_betas: Tuple[float, float] = (0.9, 0.999)
    # (tpu) capacity management: grow when alive fraction exceeds this.
    capacity_growth_trigger: float = 0.9
    capacity_growth_factor: float = 2.0


@dataclasses.dataclass
class DistributionConfig:
    """Parallelism axes (ref: DistributionParams, arguments/__init__.py:136-174)."""

    image_distribution: bool = True
    # legacy mode selector (ref arguments/__init__.py:140; modes "0"-"4"
    # are dead code in the reference — only the live "final" system
    # exists here). Parsed for command-line compatibility.
    image_distribution_mode: str = "final"
    heuristic_decay: float = 0.0
    no_heuristics_update: bool = False
    adjust_strategy_warmp_iterations: int = -1   # -1 -> one epoch (train fixup)
    # snap division points within this many tile rows of an image boundary
    # to the boundary (ref workload_division.py:889-906)
    border_divpos_coeff: float = 1.0
    save_strategy_history: bool = False

    gaussians_distribution: bool = True
    redistribute_gaussians_mode: str = "random_redistribute"  # | "no_redistribute"
    redistribute_gaussians_frequency: int = 10
    redistribute_gaussians_threshold: float = 1.1
    # replicated-mode (gaussians_distribution=False) gradient handling
    # (ref arguments/__init__.py:156-157). sync_grad_mode is parsed for
    # parity but all four reference variants are one dense psum here (XLA
    # emits the fused allreduce the "fused_dense" variant hand-builds;
    # sparse variants only pay off over NCCL's per-tensor launches).
    sync_grad_mode: str = "dense"
    # "none" | "divide_by_visible_count" | "multiply_by_visible_count" |
    # "square_multiply_by_visible_count" — per-Gaussian normalization of the
    # synced gradient by the batch-wide visible count (ref
    # gaussian_model.py:364-394; NB the reference computes the count but its
    # application path is vestigial — we apply the named semantics).
    grad_normalization_mode: str = "none"

    bsz: int = 1
    distributed_dataset_storage: bool = True
    distributed_save: bool = True
    local_sampling: bool = False
    preload_dataset_to_gpu: bool = False
    preload_dataset_to_gpu_threshold: int = 10   # GB
    num_train_cameras: int = -1
    num_test_cameras: int = -1

    # (tpu) mesh + all2all static capacities.
    mesh_axis: str = "d"
    a2a_capacity_factor: float = 2.0     # per-dest send capacity = factor * ceil(N_local_visible_est)


@dataclasses.dataclass
class TrainConfig:
    """Top-level bundle passed around the training stack."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    opt: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)
    dist: DistributionConfig = dataclasses.field(default_factory=DistributionConfig)

    test_iterations: List[int] = dataclasses.field(default_factory=lambda: [7_000, 30_000])
    save_iterations: List[int] = dataclasses.field(default_factory=lambda: [7_000, 30_000])
    checkpoint_iterations: List[int] = dataclasses.field(default_factory=list)
    start_checkpoint: Optional[str] = None
    auto_start_checkpoint: bool = False
    seed: int = 0
    log_interval: int = 250
    enable_timer: bool = False
    quiet: bool = False                  # suppress stdout (log file still written)
    log_folder: str = ""                 # "" -> model_path (ref --log_folder)
    # end-to-end wall time EXCLUDING eval/save (ref End2endTimer,
    # utils/timer.py:92-116); logged at training end when True
    end2end_time: bool = True
    # memory monitors (ref --check_gpu_memory/--check_cpu_memory/
    # --log_memory_summary, general_utils.py:283-345, 501-513)
    check_gpu_memory: bool = False
    check_cpu_memory: bool = False
    log_memory_summary: bool = False
    # capture a profiler trace of ~10 steady-state steps into
    # <model_path>/trace (ref --nsys_profile NVTX)
    nsys_profile: bool = False
    # debug / fault-injection (ref: DebugParams, arguments/__init__.py:189-201)
    stop_update_param: bool = False      # freeze params (render-determinism aid)
    drop_initial_3dgs_p: float = 0.0     # random init-point drop (scaling exps)
    # replicate checkpointed Gaussians on load for scaling experiments
    # (ref --drop_duplicate_gaussians_coeff, general_utils.py:609-644)
    drop_duplicate_gaussians_coeff: float = 1.0

    def finalize(self) -> "TrainConfig":
        """Post-parse constraint propagation (ref: init_args,
        arguments/__init__.py:275-315)."""
        if self.pipeline.max_per_tile <= 0:
            self.pipeline.max_per_tile = (
                1024 * self.pipeline.tile_w * self.pipeline.tile_h) // 256
        if self.opt.opacity_reset_until_iter == -1:
            self.opt.opacity_reset_until_iter = (
                self.opt.densify_until_iter + self.dist.bsz
            )
        self.test_iterations.sort()
        self.save_iterations.sort()
        if self.save_iterations and self.opt.iterations not in self.save_iterations:
            self.save_iterations.append(self.opt.iterations)
        self.checkpoint_iterations.sort()
        if self.dist.preload_dataset_to_gpu:
            self.dist.distributed_dataset_storage = False
            self.dist.local_sampling = False
        if self.dist.local_sampling:
            # ref init_args: local_sampling requires distributed storage
            assert self.dist.distributed_dataset_storage, (
                "local_sampling works only when "
                "distributed_dataset_storage==True")
        if not self.dist.gaussians_distribution:
            # ref init_args: replicated Gaussians => single-file saves
            self.dist.distributed_save = False
        assert self.dist.image_distribution_mode in ("", "final"), (
            "only the reference's live 'final' distribution system exists "
            "(modes 0-4 are dead code there; SURVEY.md §0)")
        if not self.log_folder:
            self.log_folder = self.model.model_path
        return self


def check_update_at_this_iter(iteration: int, bsz: int, interval: int,
                              residual: int) -> bool:
    """Batch-aware schedule predicate: does [iteration, iteration+bsz) cross a
    multiple of ``interval`` (+residual)? (ref: utils/general_utils.py:146-158)."""
    rl = iteration % interval
    rr = rl + bsz
    return (rl <= residual < rr) or (rl <= residual + interval < rr)
