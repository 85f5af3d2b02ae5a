"""How the dry run's final alive count moves with its randomness, in both
packages, on the JAX dry run's scene (jax_dryrun2.json).

The dry run's schedule splits Gaussians with random offsets and, at
D > 1, moves them between ranks to random destinations, so its final
n_alive moves with the seed; __graft_entry__.py's parity check holds two
world sizes' counts within max(2, 2%) of each other. The port draws both
from the JAX package's generator (grendel_tpu_torch/utils/prng.py). Three
modes, run from the repository root on the CPU:

    JAX_PLATFORMS=cpu python tests/data/graft_entry/seed_spread.py \\
        spread [--torch-generator] [SEEDS]

  for each seed (``cfg.seed``, the seed of the split noise's keys in both
  packages), the final n_alive of the schedule at D=1 and D=2: the JAX
  package's ``Trainer`` on 1 and 2 CPU devices, the port's
  ``MultiRankTrainer`` on 1 and 2 spawned gloo ranks; then, for each
  package, each world size's mean and standard deviation, the mean and
  spread of D=2 less D=1, and how many seeds miss the parity bound (about
  100 s a seed). ``--torch-generator`` gives the port's ranks the draws it
  took before it drew JAX's: the split noise from a ``torch.Generator``
  seeded with the seed (mixed with the rank by ``SeedSequence`` at D > 1),
  and the destinations likewise from the iteration and the rank.

    JAX_PLATFORMS=cpu python tests/data/graft_entry/seed_spread.py \\
        histories [--torch-generator] [SEEDS]

  every densify round's (iteration, clone, split, prune, alive) at D=1 and
  D=2 in both packages, and the first round where they part.

    JAX_PLATFORMS=cpu python tests/data/graft_entry/seed_spread.py \\
        thresholds

  JAX's 2-device densify history and final n_alive at the dry run's
  gradient threshold, 1e-9, and at twice it: JAX's distributed gradients
  are D times the reported loss's, so at D=2 a threshold acts as half of
  itself, and equal histories show that at 1e-9 the factor decides no
  Gaussian differently.

SEEDS defaults to 0-7. Nothing in grendel_tpu_torch imports this file.
"""

import base64
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "jax_dryrun2.json")
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

import numpy as np  # noqa: E402
import torch  # noqa: E402

THRESHOLD = 1e-9


def ref_scene_arrays() -> dict:
    """The committed JAX scene's arrays (convert.scene_arrays's keys)."""
    with open(REF) as f:
        s = json.load(f)["scene"]
    return {k: (v if k == "extent" else np.frombuffer(
        base64.b64decode(v["b64"]), v["dtype"]).reshape(v["shape"]).copy())
        for k, v in s.items()}


def history(hist) -> list:
    return [(h["iter"], h["clone"], h["split"], h["prune"], h["alive"])
            for h in hist]


def jax_run(scene, seed: int, n_devices: int,
            threshold: float = THRESHOLD) -> dict:
    """__graft_entry__.py:84-101's schedule on ``n_devices`` JAX devices,
    no checkpoint: the final n_alive and the densify history."""
    from grendel_tpu.config import TrainConfig

    from grendel_tpu.engine.trainer import Trainer

    cfg = TrainConfig()
    cfg.seed = seed
    cfg.model.sh_degree = 1
    cfg.model.model_path = tempfile.mkdtemp()
    cfg.dist.preload_dataset_to_gpu_threshold = 0
    cfg.dist.bsz = 2
    o = cfg.opt
    o.iterations, o.densify_from_iter, o.densification_interval = 48, 4, 8
    o.densify_until_iter, o.densify_grad_threshold = 48, threshold
    o.opacity_reset_interval = 24
    cfg.dist.redistribute_gaussians_frequency = 1
    cfg.dist.redistribute_gaussians_threshold = 1.0
    cfg.checkpoint_iterations, cfg.test_iterations = [], []
    cfg.save_iterations, cfg.quiet = [], True
    t = Trainer(cfg.finalize(), scene, devices=jax.devices()[:n_devices])
    t.train()
    return dict(n_alive=int(jax.device_get(t.state.alive.sum())),
                history=history(t.densify_history))


def install_torch_generators():
    """Give the port, in this process, the draws it took before it drew
    the JAX package's: ``torch.Generator`` streams."""
    from grendel_tpu_torch.parallel import redistribute as redist
    from grendel_tpu_torch.parallel.sharded import DistributedTrainer

    def mixed(seed, rank):
        return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])

    def split_noise(self, seed, n):
        if not self.replicated:
            seed = mixed(seed, self.rank)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn((n, 2, 3), generator=gen, device=self.device)

    def destinations(alive, rank, world, iteration):
        gen = torch.Generator(device=alive.device).manual_seed(
            mixed(iteration, rank))
        dest = torch.randint(0, world, alive.shape, generator=gen,
                             device=alive.device, dtype=torch.int32)
        stay = ~alive | (dest == rank)
        return torch.where(stay, torch.full_like(dest, world), dest)

    DistributedTrainer.split_noise = split_noise
    redist.destinations = destinations


def port_rank(rank: int, world: int, port: int, spec: str, seed: int,
              torch_generator: bool, out_dir: str) -> None:
    """One gloo rank of the port's dry-run schedule (no checkpoint)."""
    from grendel_tpu_torch import convert, graft_entry
    from grendel_tpu_torch.engine.trainer_dist import MultiRankTrainer
    from grendel_tpu_torch.parallel import comm

    if torch_generator:
        install_torch_generators()
    comm.join_local(rank, world, port, "cpu")
    try:
        scene = convert.scene_from_arrays(np.load(spec))
        cfg = graft_entry.dryrun_config(os.path.join(out_dir, "model"), ())
        cfg.seed = seed
        tr = MultiRankTrainer(cfg, scene, device="cpu")
        tr.train()
        rec = dict(n_alive=tr._n_alive(),
                   history=history(tr.densify_history))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        comm.destroy_group()


def port_run(spec: str, seed: int, world: int,
             torch_generator: bool = False) -> dict:
    from grendel_tpu_torch.parallel import comm

    out = tempfile.mkdtemp()
    comm.spawn_local(port_rank, (world, comm.free_port(), spec, seed,
                                 torch_generator, out), world, 900.0,
                     f"the port's {world} ranks")
    with open(os.path.join(out, "rank0.json")) as f:
        rec = json.load(f)
    rec["history"] = [tuple(h) for h in rec["history"]]
    return rec


def bound(n_1: int) -> float:
    return max(2, 0.02 * n_1)


def spread(jscene, spec, seeds, torch_generator):
    rows = {"jax": [], "port": []}
    for seed in seeds:
        j = [jax_run(jscene, seed, d)["n_alive"] for d in (1, 2)]
        p = [port_run(spec, seed, d, torch_generator)["n_alive"]
             for d in (1, 2)]
        for name, (n1, n2) in (("jax", j), ("port", p)):
            rows[name].append((n1, n2))
        print(f"seed {seed}: n_alive D=1, D=2: JAX {j[0]}, {j[1]} "
              f"({100 * (j[1] - j[0]) / j[0]:+.2f}%); port {p[0]}, {p[1]} "
              f"({100 * (p[1] - p[0]) / p[0]:+.2f}%)", flush=True)
    for name, v in rows.items():
        v = np.asarray(v, np.float64)
        parts = []
        for i, d in enumerate((1, 2)):
            parts.append(f"D={d} mean {v[:, i].mean():.1f} sd "
                         f"{v[:, i].std(ddof=1):.1f} "
                         f"({100 * v[:, i].std(ddof=1) / v[:, i].mean():.2f}%)")
        rel = 100 * (v[:, 1] - v[:, 0]) / v[:, 0]
        miss = int(sum(abs(b - a) > bound(a) for a, b in v))
        print(f"{name}: {'; '.join(parts)}; D=2 less D=1 mean {rel.mean():+.2f}%"
              f" sd {rel.std(ddof=1):.2f}%; parity misses {miss} of {len(v)} "
              f"over seeds {seeds[0]}-{seeds[-1]}", flush=True)


def histories(jscene, spec, seeds, torch_generator):
    for seed in seeds:
        for d in (1, 2):
            j = jax_run(jscene, seed, d)
            p = port_run(spec, seed, d, torch_generator)
            part = next((i for i, (a, b) in enumerate(zip(j["history"],
                                                          p["history"]))
                         if a != b), None)
            print(f"seed {seed}, D={d}: n_alive JAX {j['n_alive']}, port "
                  f"{p['n_alive']}; first round that differs: {part}",
                  flush=True)
            print(f"  JAX  (iter, clone, split, prune, alive) {j['history']}")
            print(f"  port (iter, clone, split, prune, alive) {p['history']}",
                  flush=True)


def main():
    from grendel_tpu.testing import SyntheticScene

    args = sys.argv[1:]
    mode, torch_generator = args[0], "--torch-generator" in args
    seeds = [int(a) for a in args[1:] if a != "--torch-generator"] or list(
        range(8))
    torch.set_num_threads(1)
    jscene = SyntheticScene(n_cams=6, n_test=2, width=64, height=48,
                            n_gaussians=120, n_init_points=100, sh_degree=1,
                            seed=3)
    if mode == "thresholds":
        for threshold in (THRESHOLD, 2 * THRESHOLD):
            r = jax_run(jscene, 0, 2, threshold)
            print(f"JAX, 2 devices, threshold {threshold:g}: n_alive "
                  f"{r['n_alive']}, densify (iter, clone, split, prune, "
                  f"alive) {r['history']}", flush=True)
        return
    spec = os.path.join(tempfile.mkdtemp(), "scene.npz")
    np.savez(spec, **ref_scene_arrays())
    {"spread": spread, "histories": histories}[mode](jscene, spec, seeds,
                                                     torch_generator)


if __name__ == "__main__":
    main()
