"""Port parity of grad_normalization_mode on one device: the port's
train_step with each mode against grendel_tpu's ShardedTrainer on one
device in replicated mode (the step the JAX package's one-device Trainer
runs, which applies normalize_grads_by_visibility), on the flagship scene
(capacity 512, 300 live, 128x160, SH 3, bsz 2, no pixel saturates) from a
fresh state, in the manner of tests/test_replicated.py:152. At one device
JAX's gradients carry no factor of D.

Tolerances: loss rtol 1e-5; the first Adam moments (mu = (1 - beta1) g
from a fresh state: the normalized gradient divided by bsz) and the
densify statistics (from the raw tap gradient) within 1e-4 of each leaf's
largest value, the whole-step gradient bound of tests/test_torch_train.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from grendel_tpu.cameras import batch_camera_arrays as j_batch_cams
from grendel_tpu.engine.train import XyzLrSchedule as JSched
from grendel_tpu.engine.train import train_state_init as j_state_init
from grendel_tpu.models.gaussian_model import GaussianParams as JParams
from grendel_tpu.models.optimizer import LrConfig as JLr
from grendel_tpu.parallel import ParallelConfig as JConfig
from grendel_tpu.parallel import ShardedTrainer, pack_gt_rows
from grendel_tpu_torch import testing
from grendel_tpu_torch.engine.train import train_step
from grendel_tpu_torch.models.gaussian_model import GaussianParams

FIELDS = GaussianParams._fields
MODES = ["divide_by_visible_count", "multiply_by_visible_count",
         "square_multiply_by_visible_count"]


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    return testing.flagship_inputs(seed=2)


def _port_step(inputs, mode):
    tr = testing.flagship_training(inputs, "cpu")
    return tr, train_step(tr.state, tr.cams, tr.gt_u8, tr.bg, tr.cfg,
                          tr.sh_degree, tr.bsz, tr.lambda_dssim, tr.lrs,
                          tr.xyz_sched, tr.lr_scale_mode,
                          grad_normalization_mode=mode)


def _jax_step(inputs, tr, mode, device):
    f = inputs
    cfg = JConfig(n_devices=1, bsz=tr.bsz, img_h=f.img_h, img_w=f.img_w,
                  tile_w=f.render["tile_w"], tile_h=f.render["tile_h"],
                  isect_capacity=tr.bsz * f.render["isect_capacity"],
                  max_per_tile=f.render["max_per_tile"],
                  gaussians_distribution=False).resolved(f.alive.shape[0])
    trainer = ShardedTrainer(Mesh(np.array([device]), ("d",)), cfg,
                             sh_degree=f.sh_degree,
                             lambda_dssim=tr.lambda_dssim, lrs=JLr(*tr.lrs),
                             xyz_sched=JSched(*tr.xyz_sched),
                             lr_scale_mode=tr.lr_scale_mode,
                             grad_normalization_mode=mode)
    jp = JParams(**{k: jnp.asarray(v) for k, v in f.fields.items()})
    state = trainer.shard_state(j_state_init(jp, jnp.asarray(f.alive)))
    pos = np.array([0, cfg.total_rows], np.int32)
    gt_rows = pack_gt_rows(f.cameras, pos, 1, cfg.n_row_slots, cfg.tile_h,
                           f.img_h, f.img_w, gt_override=list(f.gt_u8))
    gt_rows = jax.device_put(gt_rows, trainer.sharding_for(P("d")))
    new, m = trainer.step(state, j_batch_cams(f.cameras), gt_rows,
                          jnp.asarray(pos), jnp.asarray(f.bg))
    return jax.device_get(new), jax.device_get(m)


@pytest.mark.parametrize("mode", MODES)
def test_train_step_grad_normalization_matches_jax(inputs, mode,
                                                   eight_devices):
    tr, (ts, tm) = _port_step(inputs, mode)
    js, jm = _jax_step(inputs, tr, mode, eight_devices[0])
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _, (t_none, _) = _port_step(inputs, "none")
    for k in FIELDS:
        mu_t = getattr(ts.adam.mu, k).numpy()
        mu_j = np.asarray(getattr(js.adam.mu, k))
        sc = np.abs(mu_j).max()
        assert sc > 0, k
        np.testing.assert_allclose(mu_t / sc, mu_j / sc, atol=1e-4, rtol=0,
                                   err_msg=f"mu {k}")
        # the mode changed the gradient
        assert not np.allclose(mu_t, getattr(t_none.adam.mu, k).numpy(),
                               rtol=1e-3, atol=0), k
    sc = np.abs(np.asarray(js.stats.grad_accum)).max()
    np.testing.assert_allclose(ts.stats.grad_accum.numpy() / sc,
                               np.asarray(js.stats.grad_accum) / sc,
                               atol=1e-4, rtol=0)
    # the tap gradient stays raw: the statistics do not depend on the mode
    np.testing.assert_array_equal(ts.stats.grad_accum.numpy(),
                                  t_none.stats.grad_accum.numpy())
