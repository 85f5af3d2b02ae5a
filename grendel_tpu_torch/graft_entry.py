"""Graft entry points: a forward render of the flagship scene, and the
full-schedule distributed dry run over one rank per card.

Counterpart of the repo's ``__graft_entry__.py``:

  * :func:`entry` returns ``(fn, example_args)``: ``fn`` renders the
    flagship scene of :func:`_flagship_scene` (capacity 512, 300 live
    Gaussians, 128x160, SH 3) through ``engine/render.py render_image`` on a
    black background. It is a plain function of tensors: K1 and K3 on the
    card, their plain versions on the CPU. (JAX's ``chunk=64`` is a TPU lane
    workaround and is not copied.)
  * :func:`dryrun_multichip` runs the JAX dry run's 48-iteration schedule
    (densify that forces capacity growth, a redistribution after every
    densify, an opacity reset, a per-rank checkpoint at 24 and a resume
    from it, a distributed eval) on ``n`` spawned ranks of one process
    group, ``engine/trainer_dist.py MultiRankTrainer`` in each: NCCL with
    rank r on ``cuda:r``, or gloo with ``device="cpu"``. For n > 1 it holds
    the run to a one-rank run of the same schedule, at the JAX dry run's
    bounds. It raises when the machine has fewer cards than ranks: nothing
    falls back to gloo, to the CPU or to a simulated step.

Run from the repository root:

    python -m grendel_tpu_torch.graft_entry [--device cpu] [--n N]

It prints ``entry ok: <shape> <mean>``, then the dry run's extras line and
its summary line, the latter in ``__graft_entry__.py``'s format and key
names, so that both packages' lines parse alike
(``grendel_tpu_torch/scripts/ici_scaling.py``). N defaults to the card
count on the card and to 2 on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from .cameras import CameraArrays, camera_arrays
from .device import DEFAULT_DEVICE, resolve_device
from .engine.render import RenderConfig, render_image
from .testing import make_test_camera, params_fields, random_gaussians

# the dry run's scene and schedule (__graft_entry__.py:78-101); the scene
# is drawn with the JAX package's generator (testing.jax_random_gaussians),
# and the split noise and the destinations come from it too
# (utils/prng.py), so the dry run is the JAX package's, up to float
DRYRUN_SCENE = dict(n_cams=6, n_test=2, width=64, height=48, n_gaussians=120,
                    n_init_points=100, sh_degree=1, seed=3)
DRYRUN_ITERS, DRYRUN_CHECKPOINT = 48, 24
# the parity against one rank (__graft_entry__.py:204-213): the step-0 L1
# relative, the largest relative total loss, the held-out PSNR (dB); the
# alive counts within max(2, 2%)
PARITY_L1_STEP0, PARITY_LOSS, PARITY_DPSNR = 1e-4, 0.1, 0.3
PARITY_ALIVE_ABS, PARITY_ALIVE_REL = 2, 0.02
# a run of the ranks that outlasts this many seconds fails (a hung
# collective)
DRYRUN_TIMEOUT = 900.0
# the kernels of the path whose launches each step counts
KERNELS = ("K1", "K2", "K2s", "K3")
# on the card the main run's steps from this index on run under the
# profiler: the last 8 of 24 (iterations 32-48) with the loop's work after
# each, the densify rounds at 39 and 47 and the opacity reset at 47 among it
PROFILED_FROM_STEP = 16


def _flagship_scene(capacity=512, n=300, h=128, w=160, sh_degree=3, seed=0,
                    device=DEFAULT_DEVICE):
    """``__graft_entry__.py``'s flagship scene from the port's numpy draws:
    (params, alive, CameraArrays, (h, w)) on ``device``."""
    from .convert import params_from_numpy

    dev = resolve_device(device)
    fields, alive = params_fields(
        *random_gaussians(seed, n, sh_degree=sh_degree), capacity)
    params, alive_t = params_from_numpy(fields, alive, dev)
    return params, alive_t, camera_arrays(make_test_camera(w, h), dev), (h, w)


def entry(device=DEFAULT_DEVICE):
    """(fn, example_args): ``fn(params, alive, viewmat, full_proj, campos,
    tanfov)`` is the (3, 128, 160) forward render of the flagship scene on
    a black background; ``example_args`` are its inputs on ``device``."""
    params, alive, cam, (h, w) = _flagship_scene(device=device)
    cfg = RenderConfig(img_h=h, img_w=w, isect_capacity=8192,
                       max_per_tile=512)

    def fn(params, alive, viewmat, full_proj, campos, tanfov):
        c = CameraArrays(viewmat=viewmat, full_proj=full_proj, campos=campos,
                         tanfov=tanfov)
        bg = torch.zeros(3, dtype=torch.float32, device=viewmat.device)
        img, _ = render_image(params, alive, c, 3, cfg, bg=bg)
        return img

    return fn, (params, alive, cam.viewmat, cam.full_proj, cam.campos,
                cam.tanfov)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def dryrun_config(model_path: str, checkpoints=(DRYRUN_CHECKPOINT,)):
    """The dry run's TrainConfig (__graft_entry__.py:84-101): SH 1, the
    ground truth on the host (preload threshold 0), bsz 2, 48 iterations,
    densify from 4 every 8 until 48 at a gradient threshold of 1e-9, an
    opacity reset every 24, a redistribution after every densify, a
    checkpoint at each of ``checkpoints``."""
    from .config import TrainConfig
    from .testing import apply_config

    return apply_config(TrainConfig(), dict(
        model=dict(sh_degree=1, model_path=model_path),
        dist=dict(preload_dataset_to_gpu_threshold=0, bsz=2,
                  redistribute_gaussians_frequency=1,
                  redistribute_gaussians_threshold=1.0),
        opt=dict(iterations=DRYRUN_ITERS, densify_from_iter=4,
                 densification_interval=8, densify_until_iter=DRYRUN_ITERS,
                 densify_grad_threshold=1e-9, opacity_reset_interval=24),
        checkpoint_iterations=list(checkpoints), test_iterations=[],
        save_iterations=[], log_interval=16, quiet=True))


def _kernel_wrappers() -> dict:
    from .ops import rasterize_cuda, scan_cuda

    return {"K1": rasterize_cuda.rasterize_slots_fwd,
            "K2": rasterize_cuda.rasterize_slots_vjp,
            "K2s": rasterize_cuda.segment_sum,
            "K3": scan_cuda.cumsum_i32_multi}


class _Tap:
    """Wraps a trainer's step: records every step's (loss, l1) and its
    kernel launches; with ``profiled`` it runs the steps from
    PROFILED_FROM_STEP on under the profiler (to the run's end)."""

    def __init__(self, trainer, wrappers: dict, dev, profiled: bool):
        self.losses, self.launches = [], []
        self.prof = None
        self._real_step, self._wrappers, self._dev = (trainer._step,
                                                      wrappers, dev)
        self._profiled = profiled
        trainer._step = self._step

    def _step(self, *args):
        if self._profiled and len(self.losses) == PROFILED_FROM_STEP:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize(self._dev)
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
        before = {k: w.launches for k, w in self._wrappers.items()}
        state, m = self._real_step(*args)
        self.launches.append({k: w.launches - before[k]
                              for k, w in self._wrappers.items()})
        self.losses.append(torch.stack([m["loss"].detach().reshape(()),
                                        m["l1"].detach().reshape(())]))
        return state, m

    def device_ms_per_step(self) -> tuple:
        """The profiled steps' summed device time a step (the kernels and
        copies of the steps and of the loop's work after them), and the
        part of it in NCCL's kernels, which spin on the card until every
        rank has joined the collective; (None, None) where nothing was
        profiled (the CPU, the one-rank reference run)."""
        if self.prof is None:
            return None, None
        torch.cuda.synchronize(self._dev)
        self.prof.stop()
        total = nccl = 0.0
        for e in self.prof.key_averages():
            if str(e.device_type).endswith("CUDA"):
                us = getattr(e, "self_device_time_total", None)
                ms = (e.self_cuda_time_total if us is None else us) / 1e3
                total += ms
                nccl += ms if "nccl" in e.key.lower() else 0.0
        steps = len(self.losses) - PROFILED_FROM_STEP
        return total / steps, nccl / steps


def _check(ok: bool, world: int, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip({world}): {what}")


def _run_schedule(rank: int, world: int, spec_path: str, out_dir: str,
                  dev: torch.device, role: str) -> dict:
    """This rank's part of one run of the schedule: ``role`` "main" (the
    checkpoint at 24, the checks and the resume of
    __graft_entry__.py:132-168) or "reference" (the one-rank run that the
    parity reads: no checkpoint, no checks)."""
    from .convert import scene_from_arrays
    from .engine.checkpoint import find_latest_checkpoint
    from .engine.trainer_dist import MultiRankTrainer

    scene = scene_from_arrays(np.load(spec_path))
    model_path = os.path.join(out_dir, role)
    main = role == "main"
    cfg = dryrun_config(model_path, (DRYRUN_CHECKPOINT,) if main else ())
    bsz, sh = cfg.dist.bsz, cfg.model.sh_degree
    wrappers = _kernel_wrappers()
    log_path = os.path.join(out_dir, f"log_{role}_rk{rank}.txt")
    with open(log_path, "w") as log:
        tr = MultiRankTrainer(cfg, scene, device=dev, log_file=log)
        n_local0 = tr.n_local
        tap = _Tap(tr, wrappers, dev, main and dev.type == "cuda")
        tr.train()
        dev_ms, nccl_ms = tap.device_ms_per_step()
        losses, launches = tap.losses, tap.launches
        n_alive = tr._n_alive()
        ev = tr.eval_psnr(scene.test_cameras, sh)
        rec = dict(
            losses=torch.stack(losses).cpu().tolist(), launches=launches,
            n_local0=n_local0, n_local=tr.n_local,
            densify_rounds=len(tr.densify_history),
            densify_history=tr.densify_history,
            capacity_events=[k for k, _ in tr.capacity_events],
            opacity_resets=list(tr.opacity_reset_iters),
            redistributions=tr.redistribute_count, n_alive=n_alive, eval=ev,
            send_cap=tr._parallel_cfg(bsz, tr._blend_cap()).send_cap,
            device_ms_per_step=dev_ms, nccl_ms_per_step=nccl_ms)
        if dev.type == "cuda":
            idle = [k for k in KERNELS if any(s[k] == 0 for s in launches)]
            _check(not idle, world, f"{idle} did not launch in every step "
                   f"on the card (rank {rank})")
        if not main:
            return rec
        _check(tr.n_local > n_local0, world,
               f"no capacity growth fired (n_local {n_local0} -> "
               f"{tr.n_local}; densify_history={tr.densify_history})")
        _check(len(tr.densify_history) >= 3, world,
               f"{len(tr.densify_history)} densify rounds, not 3 or more")
        _check(bool(tr.opacity_reset_iters), world, "no opacity reset fired")
        _check(0 < n_alive <= tr.n_local * world, world,
               f"n_alive {n_alive} outside (0, {tr.n_local * world}]")
        _check(bool(np.isfinite(ev["psnr"]) and np.isfinite(ev["l1"])),
               world, f"the distributed eval is not finite: {ev}")
        # resume from the iteration-24 checkpoint set of every rank, with
        # densify off, and take two more batches
        ckpt = find_latest_checkpoint(model_path)
        _check(ckpt is not None, world, "the per-rank checkpoint is missing")
        cfg2 = dryrun_config(model_path, ())
        cfg2.start_checkpoint = ckpt
        cfg2.opt.densify_from_iter, cfg2.opt.densify_until_iter = 10 ** 9, 0
        t2 = MultiRankTrainer(cfg2, scene, device=dev, log_file=log)
        resume_iter = int(t2.state.iteration)
        _check(resume_iter == DRYRUN_CHECKPOINT, world,
               f"resumed at iteration {resume_iter}, not "
               f"{DRYRUN_CHECKPOINT}")
        resume_alive = t2._n_alive()
        t2.train(resume_iter + 2 * bsz)
        it2 = int(t2.state.iteration)
        _check(it2 >= resume_iter + 2 * bsz, world,
               f"the resumed run stopped at {it2}")
    return dict(rec, ckpt_resume_iter=resume_iter,
                resume_n_alive=resume_alive, resumed_to_iter=it2)


def _rank_main(rank: int, world: int, port: int, spec_path: str,
               out_dir: str, device: str, role: str) -> None:
    """One spawned rank: join the group (NCCL on ``cuda:rank``, gloo on the
    CPU), run the schedule, write ``<role>_rank<rank>.json``."""
    from .parallel import comm

    dev = comm.join_local(rank, world, port, device)
    try:
        rec = _run_schedule(rank, world, spec_path, out_dir, dev, role)
        with open(os.path.join(out_dir, f"{role}_rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        comm.destroy_group()


def _spawn(world: int, spec_path: str, out_dir: str, device: str,
           role: str) -> list:
    """Run ``world`` ranks of ``role`` and join them with a timeout; a
    rank's exception raises here with its traceback. Returns every rank's
    record."""
    from .parallel import comm

    comm.spawn_local(_rank_main, (world, comm.free_port(), spec_path,
                                  out_dir, device, role), world,
                     DRYRUN_TIMEOUT, f"dryrun_multichip({world}): the "
                     f"{role} ranks")
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{role}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


class ParityError(RuntimeError):
    """A dry run over n > 1 ranks that missed a bound of its parity against
    one rank; ``result`` holds the run's values, its lines printed."""

    def __init__(self, message: str, result: dict):
        super().__init__(message)
        self.result = result


def _parity(main: dict, ref: dict, world: int) -> tuple:
    """__graft_entry__.py:188-218 against the one-rank run: (the values,
    the bounds missed)."""
    _check(len(main["losses"]) == len(ref["losses"]), world,
           f"{len(main['losses'])} steps against {len(ref['losses'])}")
    tot_nd, l1_nd = np.asarray(main["losses"]).T
    tot_1d, l1_1d = np.asarray(ref["losses"]).T
    rel_l1_0 = abs(l1_nd[0] - l1_1d[0]) / max(abs(l1_1d[0]), 1e-8)
    rel_tot = np.abs(tot_nd - tot_1d) / np.maximum(np.abs(tot_1d), 1e-8)
    dpsnr = abs(main["eval"]["psnr"] - ref["eval"]["psnr"])
    n_1 = ref["n_alive"]
    alive_bound = max(PARITY_ALIVE_ABS, PARITY_ALIVE_REL * n_1)
    missed = [what for ok, what in (
        (rel_l1_0 < PARITY_L1_STEP0,
         f"step-0 L1 {rel_l1_0:.2e} relative, bound {PARITY_L1_STEP0}"),
        (float(rel_tot.max()) < PARITY_LOSS,
         f"total loss {rel_tot.max():.2e} relative at step "
         f"{int(rel_tot.argmax())}, bound {PARITY_LOSS}"),
        (abs(main["n_alive"] - n_1) <= alive_bound,
         f"n_alive {main['n_alive']} against {n_1}, bound "
         f"{alive_bound:.0f}"),
        (dpsnr < PARITY_DPSNR,
         f"held-out PSNR {main['eval']['psnr']:.4f} against "
         f"{ref['eval']['psnr']:.4f} dB, bound {PARITY_DPSNR}"),
    ) if not ok]
    return dict(rel_l1_step0=float(rel_l1_0),
                max_rel_loss_diff=float(rel_tot.max()),
                dn_alive=main["n_alive"] - n_1, dpsnr=float(dpsnr),
                ref_n_alive=n_1, ref_eval=ref["eval"]), missed


def summary_line(n: int, r: dict, status: str = "ok") -> str:
    """The summary line in __graft_entry__.py:220-230's format; a run that
    missed a parity bound says ``FAILED (...)`` where JAX's says ``ok``."""
    parity = ""
    if "dpsnr" in r:
        parity = (f"parity_vs_1dev: rel_l1_step0={r['rel_l1_step0']:.2e} "
                  f"max_rel_loss_diff={r['max_rel_loss_diff']:.2e} "
                  f"dn_alive={r['dn_alive']} dpsnr={r['dpsnr']:.4f}dB ")
    return (f"dryrun_multichip({n}): {status}, iters={r['iters']} "
            f"n_alive={r['n_alive']} {parity}"
            f"n_local={r['n_local0']}->{r['n_local']} "
            f"densify_rounds={r['densify_rounds']} "
            f"capacity_events={r['capacity_events']} "
            f"opacity_resets={r['opacity_resets']} "
            f"ckpt_resume_iter={r['ckpt_resume_iter']} "
            f"resume_n_alive={r['resume_n_alive']} "
            f"resumed_to_iter={r['resumed_to_iter']} "
            f"a2a_send_cap={r['a2a_send_cap']}/dest "
            f"a2a_fwd_volume={r['a2a_fwd_volume_mb']:.2f}MB/dev/step")


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE,
                     scene=None) -> dict:
    """Run the full-schedule dry run on ``n_devices`` ranks, one per card
    (NCCL, rank r on ``cuda:r``) or, with ``device="cpu"``, gloo ranks.
    ``scene`` (``Scene``'s duck type) defaults to the dry run's
    ``SyntheticScene`` with the JAX package's draws (the JAX dry run's
    scene), drawn and rendered on the CPU (set-up). Prints the
    extras line and the summary line; returns the summary's values, plus
    ``wall_s``, ``backend``, rank 0's kernel ``launches`` per step, each
    rank's ``device_ms_per_step`` (the profiled steps' device time a step,
    None on the CPU) and ``nccl_ms_per_step`` (its part in NCCL's kernels,
    which includes their wait for the other ranks), ``ranks_agree`` (every rank saw the same losses and counts), rank 0's
    ``losses``, ``eval``, ``densify_history`` and ``redistributions``, and
    the ``line``."""
    from .convert import scene_arrays
    from .parallel.sharded import META_F, PAYLOAD_F

    n = int(n_devices)
    if n < 1:
        raise ValueError(f"dryrun_multichip needs at least one rank, not {n}")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu") or dev.index is not None:
        raise ValueError(f"device {device!r}: pass 'cuda' (rank r on cuda:r) "
                         f"or 'cpu' (gloo ranks)")
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(
                f"dryrun_multichip({n}) runs one NCCL rank per card and this "
                f"machine has {have} card(s) for its {n} ranks; it does not "
                f"fall back to gloo, to the CPU or to a simulated step")
        resolve_device(dev)
        from . import kernels
        kernels.build()        # once, before the ranks load the libraries
    t0 = time.perf_counter()
    if scene is None:
        from .testing import SyntheticScene
        scene = SyntheticScene(**DRYRUN_SCENE, device="cpu")
    tmp = tempfile.mkdtemp(prefix="grendel_dryrun_")
    try:
        spec = os.path.join(tmp, "scene.npz")
        np.savez(spec, **scene_arrays(scene))
        ranks = _spawn(n, spec, tmp, dev.type, "main")
        ref = (_spawn(1, spec, tmp, dev.type, "reference")[0]
               if n > 1 else None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    same = ("losses", "n_alive", "n_local", "densify_rounds", "eval",
            "resume_n_alive")
    out = dict(
        n_devices=n, iters=DRYRUN_ITERS, n_alive=r0["n_alive"],
        n_local0=r0["n_local0"], n_local=r0["n_local"],
        densify_rounds=r0["densify_rounds"],
        capacity_events=r0["capacity_events"],
        opacity_resets=r0["opacity_resets"],
        ckpt_resume_iter=r0["ckpt_resume_iter"],
        resume_n_alive=r0["resume_n_alive"],
        resumed_to_iter=r0["resumed_to_iter"], a2a_send_cap=r0["send_cap"],
        a2a_fwd_volume_mb=n * r0["send_cap"] * (PAYLOAD_F + META_F) * 4 / 1e6)
    missed = []
    if ref is not None:
        parity, missed = _parity(r0, ref, n)
        out.update(parity)
    out["line"] = summary_line(
        n, out, f"FAILED ({'; '.join(missed)})" if missed else "ok")
    steps = r0["launches"]
    out.update(
        wall_s=time.perf_counter() - t0,
        backend="nccl" if dev.type == "cuda" else "gloo",
        launches=steps, losses=r0["losses"], eval=r0["eval"],
        densify_history=r0["densify_history"],
        redistributions=r0["redistributions"],
        device_ms_per_step=[r["device_ms_per_step"] for r in ranks],
        nccl_ms_per_step=[r["nccl_ms_per_step"] for r in ranks],
        ranks_agree=all(r[k] == r0[k] for r in ranks for k in same))
    per_step = " ".join(
        f"{k}={min(s[k] for s in steps)}-{max(s[k] for s in steps)}"
        for k in KERNELS)
    def by_rank(key):
        return ", ".join("not measured (CPU)" if v is None else f"{v:.3f}"
                         for v in out[key])

    print(f"dryrun_multichip({n}) extras: wall_s={out['wall_s']:.1f} "
          f"backend={out['backend']} launches_per_step_rank0: {per_step} "
          f"({len(steps)} steps) device_ms_per_step_by_rank="
          f"[{by_rank('device_ms_per_step')}] nccl_ms_per_step_by_rank="
          f"[{by_rank('nccl_ms_per_step')}] "
          f"redistributions={out['redistributions']} "
          f"ranks_agree={out['ranks_agree']}", flush=True)
    print(out["line"], flush=True)
    if missed:
        raise ParityError(f"dryrun_multichip({n}): the parity against one "
                          f"rank missed: {'; '.join(missed)}", out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The graft entry points of grendel_tpu_torch: entry() "
        "on the flagship scene, then dryrun_multichip(N).")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: NCCL ranks, one per card; cpu: gloo ranks")
    ap.add_argument("--n", type=int, default=None,
                    help="ranks (default: the card count on the card, 2 on "
                    "the CPU)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="run the dry run this many times and say whether "
                    "every run's losses, counts and eval equal the first's")
    a = ap.parse_args(argv)
    fn, args = entry(a.device)
    out = fn(*args)
    print("entry ok:", tuple(out.shape), float(out.mean()), flush=True)
    n = a.n if a.n is not None else (
        torch.cuda.device_count() if a.device == "cuda" else 2)
    runs, failed = [], []
    for _ in range(a.repeat):
        try:
            runs.append(dryrun_multichip(n, a.device))
        except ParityError as e:
            # the run's own values still answer whether runs repeat
            runs.append(e.result)
            failed.append(str(e))
    if a.repeat > 1:
        keys = ("losses", "n_alive", "n_local", "eval", "resume_n_alive")
        same = all(r[k] == runs[0][k] for r in runs[1:] for k in keys)
        print(f"dryrun_multichip({n}) repeat: {a.repeat} runs bit-equal in "
              f"{', '.join(keys)}: {same}", flush=True)
    for msg in failed:
        print(msg, file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    # run through the package's module, so that spawned ranks find
    # _rank_main under its own name
    from grendel_tpu_torch import graft_entry

    sys.exit(graft_entry.main())
