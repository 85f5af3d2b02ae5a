"""Port parity of the distributed step: grendel_tpu_torch's
DistributedTrainer in 2 gloo processes against grendel_tpu's
ShardedTrainer on a 2-device slice of the in-process mesh, in both
distribution modes, from one numpy state (200 live Gaussians in 256, SH 1,
2 cameras at 64x48, 16x16 tiles, the division at the camera border, every
bucket large enough that nothing overflows). The ground truth is a target
to train toward, as testing.flagship_inputs makes one: the same Gaussians
with their means moved by N(0, 0.03^2), rendered by the port's plain CPU
reference and quantized; so the SSIM sums are far from 0.

JAX's distributed gradients are D times the gradient of the loss it
reports: it differentiates psum(partial) under shard_map with
check_vma=False, whose transpose is a second psum (ROADMAP queue 3). The
port computes the gradient of its reported loss, so JAX's first Adam
moments and densify statistics are divided by D, its second moments by
D², and its densify threshold is multiplied by D, before the comparison.

Tolerances:
  * loss, l1, ssim: rtol 1e-5;
  * new parameters: within 1e-5 of each leaf's largest value, where the
    gradient is above 1e-6 of its leaf's largest (the first Adam step
    moves a parameter by lr * sign(g), and a gradient at rounding level
    may take either sign in either package);
  * Adam moments and grad_accum: within 1e-4 of each leaf's largest value
    (the whole-step gradient bound of tests/test_torch_train.py); denom
    and max_radii equal;
  * telemetry (entries per row, entry counts, overflow, demand) and the
    densify info table: equal;
  * render: within 2e-5 (tests/test_replicated.py's render bound).

The D=2 camera-border run simulated in one process
(testing.simulate_distributed) must equal the port's one-device
train_step within 1e-5 (loss relative; gradients of each leaf's largest).
The D=4 run on a skewed division with borders inside a camera, simulated
the same way, must equal JAX's 4-device ShardedTrainer to the gloo test's
tolerances for the loss, l1, ssim, Adam moments and grad_accum.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as tmp
from jax.sharding import Mesh, PartitionSpec as P

from grendel_tpu.cameras import batch_camera_arrays as j_batch_cams
from grendel_tpu.engine.train import XyzLrSchedule as JSched
from grendel_tpu.engine.train import train_state_init as j_state_init
from grendel_tpu.models import scaled_lrs as j_scaled_lrs
from grendel_tpu.models.gaussian_model import GaussianParams as JParams
from grendel_tpu.parallel import ParallelConfig as JConfig
from grendel_tpu.parallel import ShardedTrainer, pack_gt_rows
from grendel_tpu.testing import make_test_camera as j_camera
from grendel_tpu_torch import testing
from grendel_tpu_torch.cameras import batch_camera_arrays
from grendel_tpu_torch.convert import params_from_numpy
from grendel_tpu_torch.engine.render import RenderConfig, render_batch
from grendel_tpu_torch.models.gaussian_model import GaussianParams
from grendel_tpu_torch.parallel import comm
from grendel_tpu_torch.parallel.division import divide_rows

D, H, W, CAP, N_LIVE, BSZ, SH = 2, 64, 48, 256, 200, 2, 1
ANGLES = (0.0, 0.5)
PARALLEL = dict(n_devices=D, bsz=BSZ, img_h=H, img_w=W, isect_capacity=4096,
                max_per_tile=256, send_cap=BSZ * CAP // D)
J_PARALLEL = dict(PARALLEL, chunk=32)      # JAX's plain walk
DENSIFY = dict(min_opacity=0.005, percent_dense=0.01, use_size_prune=False)
FIELDS = GaussianParams._fields


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    fields, alive = testing.params_fields(
        *testing.random_gaussians(3, N_LIVE, sh_degree=SH), CAP)
    rng = np.random.default_rng(4)
    target = dict(fields, means3d=(fields["means3d"] + np.where(
        alive[:, None], 0.03 * rng.standard_normal((CAP, 3)), 0.0)
    ).astype(np.float32))
    with torch.no_grad():
        img, _, _ = render_batch(
            *params_from_numpy(target, alive, "cpu"),
            batch_camera_arrays([testing.make_test_camera(W, H, angle=a)
                                 for a in ANGLES], "cpu"), SH,
            RenderConfig(img_h=H, img_w=W, isect_capacity=4096,
                         max_per_tile=256, backend="torch"))
    gt_u8 = np.round(np.clip(img.numpy(), 0.0, 1.0) * 255.0).astype(np.uint8)
    cfg0 = JConfig(**J_PARALLEL).resolved(CAP // D)
    pos = divide_rows(np.ones(cfg0.total_rows), D, cfg0.n_row_slots)
    assert list(pos) == [0, cfg0.tiles_y, 2 * cfg0.tiles_y]  # camera border
    lrs, s = j_scaled_lrs(0.0025, 0.05, 0.005, 0.001, bsz=BSZ)
    sched = (1.6e-3 * s, 1.6e-5 * s, 0.01, 1000)
    # half the live Gaussians clone, half split
    max_scale = np.exp(fields["scales_raw"][alive]).max(axis=1)
    extent = float(np.median(max_scale)) / DENSIFY["percent_dense"]
    return dict(fields=fields, alive=alive, gt_u8=gt_u8, pos=pos, lrs=lrs,
                sched=sched, extent=extent)


def _threshold(avg):
    """A densify threshold in the widest gap (in log) of the averaged
    gradients' middle half, so float rounding cannot move a Gaussian across
    it."""
    v = np.sort(avg[avg > 0])
    lo, hi = len(v) // 4, 3 * len(v) // 4
    gaps = np.log(v[lo + 1:hi + 1]) - np.log(v[lo:hi])
    i = lo + int(np.argmax(gaps))
    assert gaps.max() > 1e-3
    return float(np.sqrt(v[i] * v[i + 1]))


def _jax_runs(scene, eight_devices):
    """ShardedTrainer in both modes: one step from a fresh state, a render
    of the initial model and a densify of the stepped one."""
    mesh = Mesh(np.array(eight_devices[:D]), ("d",))
    cams = [j_camera(W, H, angle=a) for a in ANGLES]
    jp = JParams(**{k: jnp.asarray(v) for k, v in scene["fields"].items()})
    out = {}
    for mode in ("sharded", "replicated"):
        cfg = JConfig(**J_PARALLEL, gaussians_distribution=mode == "sharded"
                      ).resolved(CAP // D)
        trainer = ShardedTrainer(mesh, cfg, sh_degree=SH, lambda_dssim=0.2,
                                 lrs=scene["lrs"],
                                 xyz_sched=JSched(*scene["sched"]))
        state = trainer.shard_state(j_state_init(jp,
                                                 jnp.asarray(scene["alive"])))
        gt_rows = jax.device_put(
            pack_gt_rows(cams, scene["pos"], D, cfg.n_row_slots, cfg.tile_h,
                         H, W, gt_override=list(scene["gt_u8"])),
            trainer.sharding_for(P("d")))
        bg = jnp.zeros(3)
        pos = jnp.asarray(scene["pos"])
        new, m = trainer.step(state, j_batch_cams(cams), gt_rows, pos, bg)
        imgs = trainer.render(state.params, state.alive, j_batch_cams(cams),
                              pos, bg)
        out[mode] = dict(new=jax.device_get(new), metrics=jax.device_get(m),
                         images=np.asarray(imgs), trainer=trainer)
    return out


def _port_runs(scene, tmp_path, thresholds):
    """DistributedTrainer in 2 spawned gloo processes, both modes."""
    port = comm.free_port()
    spec = dict(parallel=PARALLEL, sh_degree=SH, lambda_dssim=0.2,
                lrs=scene["lrs"]._asdict(), xyz_sched=scene["sched"],
                densify={mode: dict(DENSIFY, extent=scene["extent"],
                                    grad_threshold=thr)
                         for mode, thr in thresholds.items()})
    path = str(tmp_path / "spec.npz")
    np.savez(path, spec=json.dumps(spec), alive=scene["alive"],
             cam_angles=np.array(ANGLES), img_w=W, img_h=H,
             gt_u8=scene["gt_u8"], bg=np.zeros(3, np.float32),
             division_pos=scene["pos"], **scene["fields"])
    tmp.spawn(testing.gloo_worker, args=(D, port, path, str(tmp_path)),
              nprocs=D, join=True)
    out = {}
    for mode in ("sharded", "replicated"):
        ranks = [dict(np.load(tmp_path / f"{mode}_rank{r}.npz"))
                 for r in range(D)]
        for k in ranks[0]:
            if k.startswith("metric_") or k in ("images", "densify_info"):
                np.testing.assert_array_equal(ranks[0][k], ranks[1][k],
                                              err_msg=f"{mode} {k}")
        if mode == "sharded":     # each rank holds its slice of the state
            whole = {k: np.concatenate([r[k] for r in ranks])
                     for k in ranks[0]
                     if k.split("_")[0] in ("param", "mu", "nu", "stats")}
            out[mode] = dict(ranks[0], **whole)
        else:
            for k in ranks[0]:
                np.testing.assert_array_equal(ranks[0][k], ranks[1][k],
                                              err_msg=f"{mode} {k}")
            out[mode] = ranks[0]
    return out


def _close_to_max(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0,
                               err_msg=what)


def test_gloo_ranks_match_jax_sharded_trainer(scene, tmp_path,
                                              eight_devices):
    jx = _jax_runs(scene, eight_devices)
    # one densify threshold per mode, from JAX's statistics divided by D
    thresholds = {}
    for mode, r in jx.items():
        st = r["new"].stats
        avg = np.asarray(st.grad_accum) / D / np.maximum(
            np.asarray(st.denom), 1.0)
        thresholds[mode] = _threshold(avg)
    pt = _port_runs(scene, tmp_path, thresholds)

    for mode in ("sharded", "replicated"):
        j, t = jx[mode], pt[mode]
        jm, jn = j["metrics"], j["new"]
        for k in ("loss", "l1", "ssim"):
            np.testing.assert_allclose(t[f"metric_{k}"], jm[k], rtol=1e-5,
                                       err_msg=f"{mode} {k}")
        for k in ("per_row_entries", "num_isects", "num_kept",
                  "a2a_overflow", "a2a_demand", "telemetry"):
            np.testing.assert_array_equal(t[f"metric_{k}"], jm[k],
                                          err_msg=f"{mode} {k}")
        assert int(np.max(jm["a2a_overflow"])) == 0
        np.testing.assert_allclose(t["images"], j["images"], atol=2e-5,
                                   rtol=0, err_msg=f"{mode} render")
        for k in FIELDS:
            mu_j = np.asarray(getattr(jn.adam.mu, k)) / D
            nu_j = np.asarray(getattr(jn.adam.nu, k)) / D ** 2
            assert np.abs(mu_j).max() > 0, k
            _close_to_max(t[f"mu_{k}"], mu_j, 1e-4, f"{mode} mu {k}")
            _close_to_max(t[f"nu_{k}"], nu_j, 1e-4, f"{mode} nu {k}")
            p_j = np.asarray(getattr(jn.params, k))
            real = np.abs(mu_j) > 1e-6 * np.abs(mu_j).max()
            assert real.mean() > 0.3, k
            scale = np.abs(p_j).max()
            np.testing.assert_allclose(
                t[f"param_{k}"][real] / scale, p_j[real] / scale, atol=1e-5,
                rtol=0, err_msg=f"{mode} param {k}")
        _close_to_max(t["stats_grad_accum"],
                      np.asarray(jn.stats.grad_accum) / D, 1e-4,
                      f"{mode} grad_accum")
        for k in ("denom", "max_radii"):
            np.testing.assert_array_equal(t[f"stats_{k}"],
                                          np.asarray(getattr(jn.stats, k)),
                                          err_msg=f"{mode} {k}")
        # JAX's threshold acts on its D-times statistics
        _, info = j["trainer"].densify(
            jn, jax.random.key(0), thresholds[mode] * D,
            DENSIFY["min_opacity"], scene["extent"],
            DENSIFY["percent_dense"], DENSIFY["use_size_prune"])
        np.testing.assert_array_equal(t["densify_info"], info,
                                      err_msg=f"{mode} densify")
        assert info[:, 0].sum() > 0 and info[:, 1].sum() > 0, info


def test_camera_border_simulation_matches_train_step(scene):
    """D=2 split at the camera border, simulated in one process: its loss
    and gradients are the one-device train_step's."""
    from grendel_tpu_torch.engine.train import train_state_init
    from grendel_tpu_torch.parallel.division import pack_gt_rows as t_pack
    from grendel_tpu_torch.parallel.sharded import ParallelConfig

    params, alive = params_from_numpy(scene["fields"], scene["alive"], "cpu")
    cams = [testing.make_test_camera(W, H, angle=a) for a in ANGLES]
    rcfg = RenderConfig(img_h=H, img_w=W, isect_capacity=4096,
                        max_per_tile=256, chunk=32)
    tr = testing.training_setup(train_state_init(params, alive), cams,
                                scene["gt_u8"], np.zeros(3, np.float32),
                                rcfg, SH)
    new, m = tr.step(tr.state)
    grads = [mu / (1.0 - tr.lrs.beta1) * BSZ for mu in new.adam.mu]

    cfg = ParallelConfig(**PARALLEL).resolved(CAP // D)
    gt_rows = torch.as_tensor(t_pack(
        cams, scene["pos"], D, cfg.n_row_slots, cfg.tile_h, H, W,
        gt_override=list(scene["gt_u8"])))
    sim = testing.simulate_distributed(
        params, alive, batch_camera_arrays(cams, "cpu"), gt_rows,
        torch.as_tensor(scene["pos"]), tr.bg, cfg, SH, tr.lambda_dssim)
    np.testing.assert_allclose(float(sim.loss), float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(sim.l1), float(m["l1"].sum()), rtol=1e-5)
    np.testing.assert_allclose(float(sim.ssim), float(m["ssim"].sum()),
                               rtol=1e-5)
    for k, g_sim, g_one in zip(FIELDS, sim.grads, grads):
        assert float(g_one.abs().max()) > 0, k
        _close_to_max(g_sim.numpy(), g_one.numpy(), 1e-5, f"grad {k}")
    assert all(int(a["a2a_overflow"]) == 0 for a in sim.per_rank)


def test_inside_camera_simulation_matches_jax(scene, eight_devices):
    """D=4 on a skewed division whose borders fall inside a camera,
    simulated in one process, against JAX's ShardedTrainer on a 4-device
    mesh: (camera, Gaussian) entries go to two ranks, the exchange's
    backward sums their pieces, and SSIM sees the span borders. Loss, l1
    and ssim within 1e-5 relative; the Adam moments and grad_accum of the
    port's step from the simulated gradients within 1e-4 of each leaf's
    largest after dividing JAX's by D (nu by D²: JAX's D-times gradients,
    ROADMAP queue 3)."""
    from grendel_tpu_torch.engine.train import (XyzLrSchedule,
                                                train_state_init)
    from grendel_tpu_torch.models.densify import accumulate_densify_stats
    from grendel_tpu_torch.models.optimizer import LrConfig, adam_step
    from grendel_tpu_torch.parallel.division import pack_gt_rows as t_pack
    from grendel_tpu_torch.parallel.sharded import ParallelConfig

    d4 = 4
    kw = dict(PARALLEL, n_devices=d4, send_cap=BSZ * CAP // d4)
    cfg = ParallelConfig(**kw).resolved(CAP // d4)
    heavy = np.ones(cfg.total_rows)
    heavy[0] = 4.0                       # camera 0's top row costs more
    pos = divide_rows(heavy, d4, cfg.n_row_slots)
    # uneven, every rank owns rows, and borders inside both cameras
    assert min(np.diff(pos)) > 0 and len(set(np.diff(pos))) > 1, pos
    assert {p // cfg.tiles_y for p in pos if p % cfg.tiles_y} == {0, 1}, pos
    cams = [testing.make_test_camera(W, H, angle=a) for a in ANGLES]
    gt_rows = t_pack(cams, pos, d4, cfg.n_row_slots, cfg.tile_h, H, W,
                     gt_override=list(scene["gt_u8"]))

    mesh = Mesh(np.array(eight_devices[:d4]), ("d",))
    jcfg = JConfig(**dict(J_PARALLEL, **kw)).resolved(CAP // d4)
    trainer = ShardedTrainer(mesh, jcfg, sh_degree=SH, lambda_dssim=0.2,
                             lrs=scene["lrs"],
                             xyz_sched=JSched(*scene["sched"]))
    jp = JParams(**{k: jnp.asarray(v) for k, v in scene["fields"].items()})
    jstate = trainer.shard_state(j_state_init(jp,
                                              jnp.asarray(scene["alive"])))
    jcams = [j_camera(W, H, angle=a) for a in ANGLES]
    jn, jm = jax.device_get(trainer.step(
        jstate, j_batch_cams(jcams),
        jax.device_put(pack_gt_rows(jcams, pos, d4, jcfg.n_row_slots,
                                    jcfg.tile_h, H, W,
                                    gt_override=list(scene["gt_u8"])),
                       trainer.sharding_for(P("d"))),
        jnp.asarray(pos), jnp.zeros(3)))
    assert int(np.max(jm["a2a_overflow"])) == 0

    params, alive = params_from_numpy(scene["fields"], scene["alive"], "cpu")
    bg = torch.zeros(3)
    sim = testing.simulate_distributed(
        params, alive, batch_camera_arrays(cams, "cpu"),
        torch.as_tensor(gt_rows), torch.as_tensor(pos), bg, cfg, SH, 0.2)
    assert all(int(a["a2a_overflow"]) == 0 for a in sim.per_rank)
    for k, got in (("loss", sim.loss), ("l1", sim.l1), ("ssim", sim.ssim)):
        np.testing.assert_allclose(float(got), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    # the step DistributedTrainer.step takes from these gradients
    state = train_state_init(params, alive)
    _, adam = adam_step(state.params,
                        GaussianParams(*(g / BSZ for g in sim.grads)),
                        state.adam, LrConfig(*scene["lrs"]),
                        XyzLrSchedule(*scene["sched"])(state.iteration),
                        alive)
    stats = accumulate_densify_stats(state.stats, sim.tap_grad, sim.radii,
                                     W, H)
    for k in FIELDS:
        mu_j = np.asarray(getattr(jn.adam.mu, k)) / d4
        nu_j = np.asarray(getattr(jn.adam.nu, k)) / d4 ** 2
        assert np.abs(mu_j).max() > 0, k
        _close_to_max(getattr(adam.mu, k).numpy(), mu_j, 1e-4, f"mu {k}")
        _close_to_max(getattr(adam.nu, k).numpy(), nu_j, 1e-4, f"nu {k}")
    _close_to_max(stats.grad_accum.numpy(),
                  np.asarray(jn.stats.grad_accum) / d4, 1e-4, "grad_accum")
    for k in ("denom", "max_radii"):
        np.testing.assert_array_equal(getattr(stats, k).numpy(),
                                      np.asarray(getattr(jn.stats, k)),
                                      err_msg=k)


@pytest.fixture
def world_of_one():
    """A gloo group of one rank in this process."""
    import torch.distributed as dist

    comm.init_group("cpu", rank=0, world_size=1, store=dist.HashStore())
    yield
    comm.destroy_group()


@pytest.mark.parametrize("mode,grad_norm", [
    ("sharded", "none"), ("replicated", "none"),
    ("replicated", "divide_by_visible_count")])
def test_world_of_one_matches_train_step(scene, world_of_one, monkeypatch,
                                         mode, grad_norm):
    """DistributedTrainer on one rank, through the real collectives: the
    replicated mode takes the camera-blocked tile lists of render_batch,
    the sharded one the flat row-span lists behind its exchange; both
    equal the one-device train_step with the same grad_normalization_mode
    (loss 1e-5 relative, Adam moments and densify statistics within 1e-4
    of each leaf's largest) and render_batch (1e-5); reset_opacity is the
    model's."""
    from grendel_tpu_torch.engine.train import train_state_init, train_step
    from grendel_tpu_torch.models.densify import reset_opacity
    from grendel_tpu_torch.parallel import sharded as TS
    from grendel_tpu_torch.parallel.division import pack_gt_rows as t_pack

    params, alive = params_from_numpy(scene["fields"], scene["alive"], "cpu")
    cams = [testing.make_test_camera(W, H, angle=a) for a in ANGLES]
    rcfg = RenderConfig(img_h=H, img_w=W, isect_capacity=4096,
                        max_per_tile=256, chunk=32)
    tr = testing.training_setup(train_state_init(params, alive), cams,
                                scene["gt_u8"], np.zeros(3, np.float32),
                                rcfg, SH)
    new, m = train_step(tr.state, tr.cams, tr.gt_u8, tr.bg, tr.cfg, SH,
                        BSZ, tr.lambda_dssim, tr.lrs, tr.xyz_sched,
                        tr.lr_scale_mode, grad_normalization_mode=grad_norm)

    lists = []
    for name in ("isect_tile_rows", "isect_tile_rows_blocked"):
        real = getattr(TS, name)
        monkeypatch.setattr(TS, name, lambda *a, _r=real, _n=name, **k: (
            lists.append(_n), _r(*a, **k))[1])
    cfg = TS.ParallelConfig(**dict(PARALLEL, n_devices=1, send_cap=BSZ * CAP,
                                   isect_capacity=BSZ * 4096),
                            gaussians_distribution=mode == "sharded"
                            ).resolved(CAP)
    dt = TS.DistributedTrainer(cfg, SH, tr.lambda_dssim, tr.lrs,
                               tr.xyz_sched, grad_normalization_mode=grad_norm)
    pos = torch.tensor([0, cfg.total_rows], dtype=torch.int32)
    gt_rows = torch.as_tensor(t_pack(cams, pos.numpy(), 1, cfg.n_row_slots,
                                     cfg.tile_h, H, W,
                                     gt_override=list(scene["gt_u8"]))[0])
    state = dt.shard_state(tr.state)
    d_new, dm = dt.step(state, tr.cams, gt_rows, pos, tr.bg)
    assert lists == ["isect_tile_rows_blocked" if mode == "replicated"
                     else "isect_tile_rows"]
    np.testing.assert_allclose(float(dm["loss"]), float(m["loss"]),
                               rtol=1e-5)
    assert int(dm["a2a_overflow"][0]) == 0
    assert int(d_new.iteration) == int(new.iteration) == BSZ
    for a, b, what in zip(d_new.adam.mu + d_new.adam.nu + tuple(d_new.stats),
                          new.adam.mu + new.adam.nu + tuple(new.stats),
                          [f"mu {k}" for k in FIELDS]
                          + [f"nu {k}" for k in FIELDS]
                          + list(new.stats._fields)):
        _close_to_max(a.numpy(), b.numpy(), 1e-4, what)
    with torch.no_grad():
        imgs, _, _ = render_batch(params, alive, tr.cams, SH, rcfg, bg=tr.bg)
    got = dt.render(state.params, state.alive, tr.cams, pos, tr.bg)
    np.testing.assert_allclose(got.numpy(), imgs.numpy(), atol=1e-5, rtol=0)
    reset = dt.reset_opacity(d_new)
    want = reset_opacity(d_new.params, d_new.adam)
    for a, b in zip(reset.params + reset.adam.mu, want[0] + want[1].mu):
        assert torch.equal(a, b)


def test_random_background_is_one_draw_per_step_on_every_rank(
        scene, world_of_one, eight_devices):
    """With random_background, each step draws JAX's background from
    bg_seed and the state's iteration, so every rank draws the same one:
    with no live Gaussian and a zero ground truth the rows are the
    background alone, and the step's l1 is its mean. Three steps of the
    port's DistributedTrainer at world size 1 against JAX's ShardedTrainer
    on one device (tests/test_parallel.py's readout): the port's l1
    within 1e-6 relative of BSZ times the mean of JAX's draw at the step's
    iteration (``jax.random.uniform(fold_in(key(7), it), (3,))``, taken
    in float64), JAX's step's l1 within 2e-5 of the port's (JAX sums the
    float32 values of a step less exactly: up to 9.9e-6 off the port's,
    which is at most 1.4e-7 off that mean), and two port runs
    bit-equal."""
    from grendel_tpu_torch.engine.train import (XyzLrSchedule,
                                                train_state_init)
    from grendel_tpu_torch.models.optimizer import LrConfig
    from grendel_tpu_torch.parallel import sharded as TS

    kw = dict(n_devices=1, random_background=True, bg_seed=7)
    jcfg = JConfig(**dict(J_PARALLEL, **kw)).resolved(CAP)
    jtr = ShardedTrainer(Mesh(np.array(eight_devices[:1]), ("d",)), jcfg,
                         sh_degree=SH, lambda_dssim=0.2, lrs=scene["lrs"],
                         xyz_sched=JSched(*scene["sched"]))
    jp = JParams(**{k: jnp.asarray(v) for k, v in scene["fields"].items()})
    jstate = jtr.shard_state(j_state_init(
        jp, jnp.zeros(CAP, dtype=bool)))
    jcams = j_batch_cams([j_camera(W, H, angle=a) for a in ANGLES])
    jgt = jax.device_put(
        np.zeros((1, jcfg.n_row_slots, 3, jcfg.tile_h, W), np.uint8),
        jtr.sharding_for(P("d")))
    jpos = jnp.asarray([0, jcfg.total_rows], jnp.int32)
    jax_l1, want = [], []
    for step in range(3):
        jstate, jm = jtr.step(jstate, jcams, jgt, jpos, jnp.zeros(3))
        jax_l1.append(float(jm["l1"]))
        bg = jax.random.uniform(jax.random.fold_in(jax.random.key(7),
                                                   step * BSZ), (3,))
        want.append(BSZ * np.asarray(bg, np.float64).mean())

    params, alive = params_from_numpy(scene["fields"], scene["alive"], "cpu")
    cfg = TS.ParallelConfig(**dict(PARALLEL, **kw)).resolved(CAP)
    cams = batch_camera_arrays([testing.make_test_camera(W, H, angle=a)
                                for a in ANGLES], "cpu")
    pos = torch.tensor([0, cfg.total_rows], dtype=torch.int32)
    gt_rows = torch.zeros((cfg.n_row_slots, 3, cfg.tile_h, W),
                          dtype=torch.uint8)
    runs = []
    for _ in range(2):
        dt = TS.DistributedTrainer(cfg, SH, 0.2, LrConfig(*scene["lrs"]),
                                   XyzLrSchedule(*scene["sched"]))
        state = dt.shard_state(train_state_init(params,
                                                torch.zeros_like(alive)))
        l1s = []
        for _ in range(3):
            state, m = dt.step(state, cams, gt_rows, pos, torch.zeros(3))
            l1s.append(float(m["l1"]))
        runs.append(l1s)
    np.testing.assert_allclose(runs[0], want, rtol=1e-6)
    np.testing.assert_allclose(jax_l1, runs[0], rtol=2e-5)
    assert runs[0] == runs[1] and len(set(runs[0])) == 3
