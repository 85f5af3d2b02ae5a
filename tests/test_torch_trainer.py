"""Port parity of the host training loop: grendel_tpu_torch's Trainer
against grendel_tpu's on one device (``devices=jax.devices()[:1]``, its
replicated mode), on the same scene and schedule.

The scene is grendel_tpu's SyntheticScene of __graft_entry__.py's
dryrun (6 train and 2 test cameras at 64x48, 120 Gaussians, 100 initial
points, SH 1, seed 3), carried to the port by convert.scene_from_numpy;
the schedule is the dryrun's (48 iterations at bsz 2, densify from 4
every 8 with a 1e-9 gradient threshold so every round clones or splits
and the capacity grows, opacity reset every 24, a checkpoint at 24), with
a white background so the background term is live. The port's densify
noise is the draw JAX makes from ``jax.random.key(seed * 1000003 + it)``.
Each step's (loss, l1) is recorded by a tap on each trainer's step.

Bounds: the L1 at step 0 within 1e-4 relative and every loss before the
first densify within 1e-4 relative (two libraries' float32 sums; the JAX
loop's loss is _row_span_loss over the tile rows, the port's batch_loss
over the images); every later loss within 1e-3 (float drift after the
first split; measured 1.5e-4); the first densify's counts equal; after
48 iterations the same capacity events and opacity-reset iterations,
n_alive within
max(2, 2%) and the held-out PSNR within 0.3 dB, the bounds of
__graft_entry__.py's parity check; and the port resumes from its
iteration-24 checkpoint to iteration 28.
"""

import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

from grendel_tpu.config import TrainConfig as JConfig
from grendel_tpu.engine.trainer import Trainer as JTrainer
from grendel_tpu.testing import SyntheticScene as JScene
from grendel_tpu_torch import convert
from grendel_tpu_torch.config import TrainConfig
from grendel_tpu_torch.engine.checkpoint import find_latest_checkpoint
from grendel_tpu_torch.engine.trainer import Trainer, check_ported

SEED = 0


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores; torch's spinning intra-op
    threads would then slow every test on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _schedule(cfg, model_path):
    """__graft_entry__.py's dryrun schedule, white background."""
    cfg.model.sh_degree = 1
    cfg.model.model_path = model_path
    cfg.model.white_background = True
    cfg.dist.bsz = 2
    o = cfg.opt
    o.iterations = 48
    o.densify_from_iter = 4
    o.densification_interval = 8
    o.densify_until_iter = 48
    o.densify_grad_threshold = 1e-9
    o.opacity_reset_interval = 24
    cfg.checkpoint_iterations = [24]
    cfg.test_iterations = []
    cfg.save_iterations = []
    cfg.log_interval = 16
    cfg.quiet = True
    cfg.seed = SEED
    return cfg.finalize()


def _camera_arrays(cams):
    return dict(
        world_view=np.stack([c.world_view for c in cams]),
        full_proj=np.stack([c.full_proj for c in cams]),
        camera_center=np.stack([c.camera_center for c in cams]),
        tanfov=np.array([[c.tanfovx, c.tanfovy] for c in cams], np.float32),
        uid=np.array([c.uid for c in cams]),
        gt_u8=np.stack([c.gt_image_u8 for c in cams]))


def _tap_jax(trainer):
    """__graft_entry__.py's tap: every step's (loss, l1)."""
    losses = []
    get_trainer = trainer._trainer

    def tapped(sh_degree):
        st = get_trainer(sh_degree)
        if not getattr(st, "_loss_tapped", False):
            real_step = st.step

            def step(*args, **kw):
                new_state, metrics = real_step(*args, **kw)
                losses.append((float(metrics["loss"]), float(metrics["l1"])))
                return new_state, metrics

            st.step = step
            st._loss_tapped = True
        return st

    trainer._trainer = tapped
    return losses


def _tap_port(trainer):
    losses = []
    real_step = trainer._step

    def step(*args, **kw):
        state, metrics = real_step(*args, **kw)
        losses.append((float(metrics["loss"]), float(metrics["l1"].sum())))
        return state, metrics

    trainer._step = step
    return losses


def _jax_noise(trainer):
    """The port's densify noise made JAX's: the draw of
    jax.random.key(seed), the key JAX's loop hands densify_and_prune."""
    def noise(seed):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.key(seed), (trainer.capacity, 2, 3))))
    return noise


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jscene = JScene(n_cams=6, n_test=2, width=64, height=48, n_gaussians=120,
                    n_init_points=100, sh_degree=1, seed=3)
    tscene = convert.scene_from_numpy(
        _camera_arrays(jscene.train_cameras),
        _camera_arrays(jscene.test_cameras), jscene.point_cloud.points,
        jscene.point_cloud.colors, jscene.cameras_extent)

    jt = JTrainer(_schedule(JConfig(), str(tmp_path_factory.mktemp("jax"))),
                  jscene, devices=jax.devices()[:1])
    j_losses = _tap_jax(jt)
    jt.train()
    j_eval = jt.eval_psnr(jscene.test_cameras, sh_degree=1)

    cfg = _schedule(TrainConfig(), str(tmp_path_factory.mktemp("port")))
    tt = Trainer(cfg, tscene, device="cpu")
    t_losses = _tap_port(tt)
    tt._split_noise = _jax_noise(tt)
    tt.train()
    t_eval = tt.eval_psnr(tscene.test_cameras, sh_degree=1)
    return dict(jt=jt, tt=tt, j_losses=np.array(j_losses),
                t_losses=np.array(t_losses), j_eval=j_eval, t_eval=t_eval,
                cfg=cfg, tscene=tscene)


def test_losses_match_before_the_first_densify(runs):
    j, t = runs["j_losses"], runs["t_losses"]
    assert j.shape == t.shape == (24, 2)
    rel_l1_0 = abs(t[0, 1] - j[0, 1]) / abs(j[0, 1])
    assert rel_l1_0 < 1e-4, rel_l1_0
    first = runs["jt"].densify_history[0]["iter"]      # sched_it 7: 4 steps
    n_pre = -(-first // 2)
    assert n_pre == 4
    rel = np.abs(t[:n_pre, 0] - j[:n_pre, 0]) / np.abs(j[:n_pre, 0])
    assert rel.max() < 1e-4, rel


def test_losses_track_jax_through_the_schedule(runs):
    """After the first split the two runs drift only in float (measured
    1.5e-4 at most); densify noise drawn from another key than JAX's moves
    the children elsewhere and the losses by up to 5e-2."""
    j, t = runs["j_losses"], runs["t_losses"]
    rel = np.abs(t[:, 0] - j[:, 0]) / np.abs(j[:, 0])
    assert rel.max() < 1e-3, rel


def test_first_densify_counts_match(runs):
    jh, th = runs["jt"].densify_history, runs["tt"].densify_history
    assert len(th) == len(jh) == 6
    assert th[0] == jh[0], (th[0], jh[0])
    # the 1e-9 threshold clones or splits every seen Gaussian each round
    assert all(h["clone"] + h["split"] > 0 for h in th)


def test_schedule_events_match(runs):
    jt, tt = runs["jt"], runs["tt"]
    assert tt.capacity_events == jt.capacity_events
    assert [k for k, _ in tt.capacity_events].count("capacity_grow") >= 1
    assert tt.opacity_reset_iters == jt.opacity_reset_iters == [23, 47]
    assert [h["iter"] for h in tt.densify_history] == \
        [h["iter"] for h in jt.densify_history]
    assert tt.capacity == jt.n_local
    assert int(tt.state.iteration) == 48 and int(tt.state.adam.count) == 24


def test_alive_and_heldout_psnr_match(runs):
    n_t = int(runs["tt"].state.alive.sum())
    n_j = int(np.asarray(runs["jt"].state.alive).sum())
    assert abs(n_t - n_j) <= max(2, 0.02 * n_j), (n_t, n_j)
    assert n_t == runs["tt"].densify_history[-1]["alive"]
    te, je = runs["t_eval"], runs["j_eval"]
    assert te["n"] == je["n"] == 2
    assert np.isfinite(te["psnr"]) and np.isfinite(te["l1"])
    assert abs(te["psnr"] - je["psnr"]) < 0.3, (te, je)
    assert all(bool(torch.isfinite(p).all()) for p in runs["tt"].state.params)


def test_resume_from_checkpoint(runs):
    cfg = runs["cfg"]
    ckpt = find_latest_checkpoint(cfg.model.model_path)
    assert ckpt is not None and ckpt.endswith(os.path.join("checkpoints",
                                                           "24"))
    cfg2 = dataclasses.replace(cfg)
    cfg2.start_checkpoint = ckpt
    cfg2.opt = dataclasses.replace(cfg.opt, densify_from_iter=10 ** 9,
                                   densify_until_iter=0)
    cfg2.checkpoint_iterations = []
    t2 = Trainer(cfg2, runs["tscene"], device="cpu")
    assert int(t2.state.iteration) == 24
    assert t2.densify_count == 3
    n_resumed = int(t2.state.alive.sum())
    assert n_resumed == runs["tt"].densify_history[2]["alive"]
    t2.train(28)
    assert int(t2.state.iteration) == 28
    assert int(t2.state.alive.sum()) == n_resumed
    assert all(bool(torch.isfinite(p).all()) for p in t2.state.params)


@pytest.mark.parametrize("field,value", [
    ("local_sampling", True), ("save_strategy_history", True),
    ("grad_normalization_mode", "divide_by_visible_count")])
def test_unported_options_raise(field, value):
    cfg = TrainConfig()
    setattr(cfg.dist, field, value)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        check_ported(cfg)
