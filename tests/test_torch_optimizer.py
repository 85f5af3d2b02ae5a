"""Port parity of the optimizer and the densify statistics: scaled_lrs,
expon_lr, adam_step (three steps fed the same gradients in both packages,
masked by alive) and accumulate_densify_stats, against grendel_tpu on
numpy inputs.

Tolerances: LRs and schedule values rtol 1e-6 (float32 log/exp in two
libraries); Adam parameters and moments rtol 1e-6, atol 1e-9 (the same
float32 formulas; the moments reach 1e-8), against grendel_tpu's adam_step
run eagerly. Under jax.jit XLA fuses the update and rounds it differently
from its own eager run (4.8e-7 on a parameter at lr 0.07, measured on this
test's inputs), which is the gap the whole-step test
(test_torch_train.py) leaves room for; densify statistics rtol 1e-6.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from grendel_tpu.models import densify as JD
from grendel_tpu.models import optimizer as JO
from grendel_tpu.models.gaussian_model import GaussianParams as JParams
from grendel_tpu_torch import config
from grendel_tpu_torch.models import densify as TD
from grendel_tpu_torch.models import optimizer as TO
from grendel_tpu_torch.models.gaussian_model import GaussianParams

N = 64


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores; torch's spinning intra-op
    threads would then slow every test on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["sqrt", "linear", "accumu"])
@pytest.mark.parametrize("bsz", [1, 4])
def test_scaled_lrs_match_jax(mode, bsz):
    opt = config.OptimizationConfig()
    args = (opt.feature_lr, opt.opacity_lr, opt.scaling_lr, opt.rotation_lr)
    t_cfg, t_s = TO.scaled_lrs(*args, bsz=bsz, lr_scale_mode=mode,
                               lr_scale_pos_and_scale=0.5)
    j_cfg, j_s = JO.scaled_lrs(*args, bsz=bsz, lr_scale_mode=mode,
                               lr_scale_pos_and_scale=0.5)
    assert t_cfg._fields == j_cfg._fields
    np.testing.assert_allclose(t_s, j_s, rtol=1e-6)
    np.testing.assert_allclose(tuple(t_cfg), tuple(j_cfg), rtol=1e-6)
    with pytest.raises(ValueError, match="lr_scale_mode"):
        TO.scaled_lrs(*args, bsz=bsz, lr_scale_mode="cubic")


def test_config_defaults_are_the_jax_packages():
    from grendel_tpu import config as jconfig

    for name in ("ModelConfig", "PipelineConfig", "OptimizationConfig",
                 "DistributionConfig", "TrainConfig"):
        assert (dataclasses.asdict(getattr(config, name)())
                == dataclasses.asdict(getattr(jconfig, name)())), name
    opt = config.OptimizationConfig()
    assert (opt.position_lr_init, opt.feature_lr, opt.opacity_lr,
            opt.scaling_lr, opt.rotation_lr, opt.lambda_dssim,
            opt.lr_scale_mode) == (1.6e-4, 0.0025, 0.05, 0.005, 0.001, 0.2,
                                   "sqrt")
    for it in range(0, 40, 3):
        for bsz in (1, 2, 4):
            assert (config.check_update_at_this_iter(it, bsz, 10, 1)
                    == jconfig.check_update_at_this_iter(it, bsz, 10, 1))
    tc = config.TrainConfig()
    tc.dist.bsz = 4
    tc.finalize()
    assert tc.pipeline.max_per_tile == 2048
    assert tc.opt.opacity_reset_until_iter == 15_004


@pytest.mark.parametrize("delay_steps", [0, 50])
def test_expon_lr_matches_jax(delay_steps):
    for step in (-3, 0, 1, 7, 100, 15_000, 29_999, 30_000, 45_000):
        t = TO.expon_lr(torch.tensor(step, dtype=torch.int32), 1.6e-4,
                        1.6e-6, delay_steps, 0.01, 30_000)
        j = JO.expon_lr(jnp.int32(step), 1.6e-4, 1.6e-6, delay_steps, 0.01,
                        30_000)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   err_msg=str(step))
    assert float(TO.expon_lr(5, 0.0, 0.0)) == 0.0


def _leaves(rng, scale):
    shapes = dict(means3d=(N, 3), sh_dc=(N, 1, 3), sh_rest=(N, 15, 3),
                  scales_raw=(N, 3), quats=(N, 4), opacities_raw=(N,))
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("mode", ["sqrt", "accumu"])
def test_adam_steps_match_jax(mode):
    rng = np.random.default_rng(0)
    params = _leaves(rng, 1.0)
    alive = rng.uniform(size=N) < 0.8
    grads = [_leaves(rng, 1e-4) for _ in range(3)]
    lrs, _ = TO.scaled_lrs(0.0025, 0.05, 0.005, 0.001, bsz=2,
                           lr_scale_mode=mode)
    jlrs = JO.LrConfig(*lrs)

    tp = GaussianParams(**{k: torch.tensor(v) for k, v in params.items()})
    jp = JParams(**{k: jnp.asarray(v) for k, v in params.items()})
    ts, js = TO.adam_init(tp), JO.adam_init(jp)
    ta = torch.tensor(alive)
    jstep = JO.adam_step
    for i, g in enumerate(grads):
        xyz_t = TO.expon_lr(torch.tensor(2 * i), 1.6e-4, 1.6e-6, 0, 0.01,
                            30_000)
        xyz_j = JO.expon_lr(jnp.int32(2 * i), 1.6e-4, 1.6e-6, 0, 0.01,
                            30_000)
        tp, ts = TO.adam_step(
            tp, GaussianParams(**{k: torch.tensor(v) for k, v in g.items()}),
            ts, lrs, xyz_t, ta)
        jp, js = jstep(jp, JParams(**{k: jnp.asarray(v)
                                      for k, v in g.items()}),
                       js, jlrs, xyz_j, jnp.asarray(alive))
    assert int(ts.count) == int(js.count) == 3
    for k in GaussianParams._fields:
        for t_, j_ in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            np.testing.assert_allclose(getattr(t_, k).numpy(),
                                       np.asarray(getattr(j_, k)),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
        # dead slots keep their parameters; live ones moved
        p = getattr(tp, k).numpy()
        np.testing.assert_array_equal(p[~alive], params[k][~alive])
        assert (p[alive] != params[k][alive]).all(), k


def test_accumulate_densify_stats_matches_jax():
    rng = np.random.default_rng(3)
    b, w, h = 2, 160, 128
    t_stats = TD.densify_stats_init(N, "cpu")
    j_stats = JD.densify_stats_init(N)
    for _ in range(3):
        g = (1e-4 * rng.standard_normal((b, N, 2))).astype(np.float32)
        radii = np.where(rng.uniform(size=(b, N)) < 0.6,
                         rng.integers(1, 40, (b, N)), 0).astype(np.int32)
        t_stats = TD.accumulate_densify_stats(
            t_stats, torch.tensor(g), torch.tensor(radii), w, h)
        j_stats = JD.accumulate_densify_stats(
            j_stats, jnp.asarray(g), jnp.asarray(radii), w, h)
    for k in TD.DensifyStats._fields:
        np.testing.assert_allclose(getattr(t_stats, k).numpy(),
                                   np.asarray(getattr(j_stats, k)),
                                   rtol=1e-6, err_msg=k)
    assert float(t_stats.denom.max()) > 0 and float(t_stats.max_radii.max()) > 0
