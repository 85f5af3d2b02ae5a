"""Port parity of the single-GPU training step: grendel_tpu_torch's
train_step against grendel_tpu's (RenderConfig(backend="pallas_interpret"))
on the flagship scene (capacity 512, 300 live, 128x160, SH 3, bsz 2, fixed
non-zero background, a ground truth rendered from jittered means), both
starting from one mid-training state: Adam
moments, count, densify statistics and iteration made with numpy, held as
a grendel_tpu TrainState and carried across with
convert.train_state_from_numpy.

Tolerances:
  * loss, l1, ssim: rtol 1e-5 (float32 sums over 61,440 pixel values in
    two libraries' orders; no pixel saturates, so the blends agree);
  * Adam moments, densify statistics and the step's gradients (recovered
    from the first moment): atol 1e-4, rtol 1e-3, the JAX package's own
    whole-step gradient bound (tests/test_rasterize_pallas.py:140-147),
    the moments and gradients also after scaling each leaf by its largest
    value (the moments are far below 1e-4);
  * parameters: atol 1e-6, rtol 1e-5, where |grad| exceeds 1e-6 times the
    leaf's largest. Adam divides by sqrt(v), so a gradient at rounding
    level moves its parameter by up to lr whatever its sign; where the
    gradient is real the two packages step alike.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from grendel_tpu.cameras import batch_camera_arrays as j_batch_cams
from grendel_tpu.engine import render as JR
from grendel_tpu.engine.train import TrainState as JState
from grendel_tpu.engine.train import XyzLrSchedule as JSched
from grendel_tpu.engine.train import train_step as j_train_step
from grendel_tpu.models.densify import DensifyStats as JStats
from grendel_tpu.models.gaussian_model import GaussianParams as JParams
from grendel_tpu.models.optimizer import AdamState as JAdam
from grendel_tpu.models.optimizer import LrConfig as JLr
from grendel_tpu_torch import convert, testing
from grendel_tpu_torch.config import OptimizationConfig
from grendel_tpu_torch.models.gaussian_model import GaussianParams

FIELDS = GaussianParams._fields


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores; torch's spinning intra-op
    threads would then slow every test on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mid_training_state(inputs, seed=7):
    """A grendel_tpu TrainState part way through training, from numpy."""
    rng = np.random.default_rng(seed)
    mu, nu = {}, {}
    for k, v in inputs.fields.items():
        mu[k] = (1e-4 * rng.standard_normal(v.shape)).astype(np.float32)
        nu[k] = (mu[k] ** 2 * rng.uniform(1.0, 4.0, v.shape)).astype(
            np.float32)
    n = inputs.alive.shape[0]
    denom = rng.integers(0, 12, n).astype(np.float32)
    stats = dict(grad_accum=(denom * rng.uniform(0, 1e-3, n)).astype(
        np.float32), denom=denom,
        max_radii=rng.integers(0, 30, n).astype(np.float32))
    jp = lambda d: JParams(**{k: jnp.asarray(d[k]) for k in FIELDS})
    return JState(params=jp(inputs.fields), alive=jnp.asarray(inputs.alive),
                  adam=JAdam(mu=jp(mu), nu=jp(nu), count=jnp.int32(7)),
                  stats=JStats(**{k: jnp.asarray(v)
                                  for k, v in stats.items()}),
                  iteration=jnp.int32(14))


def _to_numpy(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _carry_across(js):
    return convert.train_state_from_numpy(
        _to_numpy(js.params), np.asarray(js.alive), _to_numpy(js.adam.mu),
        _to_numpy(js.adam.nu), js.adam.count, _to_numpy(js.stats),
        js.iteration, device="cpu")


def _jax_step(inputs, tr, js):
    cfg = JR.RenderConfig(img_h=inputs.img_h, img_w=inputs.img_w,
                          **inputs.render, backend="pallas_interpret")
    sched = JSched(*tr.xyz_sched)
    return j_train_step(js, j_batch_cams(inputs.cameras),
                        jnp.asarray(inputs.gt_u8), jnp.asarray(inputs.bg),
                        cfg, inputs.sh_degree, tr.bsz, tr.lambda_dssim,
                        JLr(*tr.lrs), sched, tr.lr_scale_mode)


def test_train_step_matches_jax():
    inputs = testing.flagship_inputs(seed=0)
    js = _mid_training_state(inputs)
    ts = _carry_across(js)
    tr = testing.flagship_training(inputs, device="cpu", state=ts)
    assert int(ts.adam.count) == 7 and int(ts.iteration) == 14
    js1, jm = _jax_step(inputs, tr, js)
    ts1, tm = tr.step(ts)

    for k in ("loss", "l1", "ssim", "xyz_lr"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tm["num_isects"].numpy(),
                                  np.asarray(jm["num_isects"]))
    assert int(ts1.iteration) == int(js1.iteration) == 16
    assert int(ts1.adam.count) == int(js1.adam.count) == 8

    b1 = tr.lrs.beta1
    for k in FIELDS:
        mu_t = getattr(ts1.adam.mu, k).numpy()
        mu_j = np.asarray(getattr(js1.adam.mu, k))
        nu_t = getattr(ts1.adam.nu, k).numpy()
        nu_j = np.asarray(getattr(js1.adam.nu, k))
        for name, t_, j_ in (("mu", mu_t, mu_j), ("nu", nu_t, nu_j)):
            np.testing.assert_allclose(t_, j_, atol=1e-4, rtol=1e-3,
                                       err_msg=f"{name} {k}")
            # the moments are far below 1e-4: hold them, scaled by the
            # leaf's largest, to the same bound
            sc = np.abs(j_).max()
            np.testing.assert_allclose(t_ / sc, j_ / sc, atol=1e-4,
                                       rtol=1e-3, err_msg=f"{name} {k}")
        # the step's gradient, recovered from the first moment
        mu0 = getattr(ts.adam.mu, k).numpy()
        g_t = (mu_t - b1 * mu0) / (1 - b1)
        g_j = (mu_j - b1 * mu0) / (1 - b1)
        scale = np.abs(g_j).max()
        assert scale > 0, k
        np.testing.assert_allclose(g_t / scale, g_j / scale, atol=1e-4,
                                   rtol=1e-3, err_msg=f"grad {k}")
        p_t = getattr(ts1.params, k).numpy()
        p_j = np.asarray(getattr(js1.params, k))
        real = np.abs(g_j) > 1e-6 * scale
        assert real.mean() > 0.3, k
        np.testing.assert_allclose(p_t[real], p_j[real], atol=1e-6,
                                   rtol=1e-5, err_msg=f"param {k}")
        # dead slots keep their parameters
        dead = ~inputs.alive
        np.testing.assert_array_equal(p_t[dead], inputs.fields[k][dead])
    for k in ("grad_accum", "denom", "max_radii"):
        np.testing.assert_allclose(getattr(ts1.stats, k).numpy(),
                                   np.asarray(getattr(js1.stats, k)),
                                   atol=1e-4, rtol=1e-3, err_msg=k)


def test_train_steps_lower_the_loss():
    tr = testing.flagship_training(testing.flagship_inputs(seed=3), "cpu")
    state, losses = tr.state, []
    for _ in range(4):
        state, m = tr.step(state)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert int(state.iteration) == 8 and int(state.adam.count) == 4
    assert all(bool(torch.isfinite(p).all()) for p in state.params)
    # the densify statistics saw every visible Gaussian in every step
    assert float(state.stats.denom.max()) == 8.0
    assert float(state.stats.grad_accum.max()) > 0.0


def test_accumu_mode_keeps_the_gradient_summed():
    """lr_scale_mode reaches the step with the learning rates it scaled:
    "accumu" skips the division by bsz, so the step's gradient, recovered
    from the first Adam moment of a fresh state (mu = (1 - beta1) g, beta1
    scaled by the mode), is bsz times that of "sqrt"."""
    inputs = testing.flagship_inputs(seed=4)
    grads = {}
    for mode in ("sqrt", "accumu"):
        tr = testing.flagship_training(
            inputs, "cpu", opt=OptimizationConfig(lr_scale_mode=mode))
        assert tr.lr_scale_mode == mode
        mu = tr.step(tr.state)[0].adam.mu
        grads[mode] = [m / (1.0 - tr.lrs.beta1) for m in mu]
    for k, a, s in zip(FIELDS, grads["accumu"], grads["sqrt"]):
        assert float(s.abs().max()) > 0, k
        torch.testing.assert_close(a, 2.0 * s, atol=0.0, rtol=1e-5,
                                   msg=k)


def test_train_state_from_numpy_round_trip():
    inputs = testing.flagship_inputs(seed=1)
    js = _mid_training_state(inputs, seed=2)
    ts = _carry_across(js)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ts.params, k).numpy(),
                                      inputs.fields[k])
        np.testing.assert_array_equal(getattr(ts.adam.nu, k).numpy(),
                                      np.asarray(getattr(js.adam.nu, k)))
    assert ts.iteration.dtype == torch.int32 and ts.adam.count.dtype == \
        torch.int32
    with pytest.raises(ValueError, match="DensifyStats"):
        convert.train_state_from_numpy(
            inputs.fields, inputs.alive, inputs.fields, inputs.fields, 0,
            {"denom": np.zeros(512)}, 0, device="cpu")


def test_garden_training_setup():
    """The garden set-up's shapes and optimizer at a reduced Gaussian count
    (the full 200,000 are for the card)."""
    tr = testing.garden_training(seed=0, device="cpu", n_live=3000,
                                 capacity=4096)
    assert tr.gt_u8.shape == (2, 3, 840, 1296) and tr.gt_u8.dtype == \
        torch.uint8
    assert (tr.cfg.tile_w, tr.cfg.tile_h, tr.cfg.max_per_tile) == (32, 16,
                                                                  2048)
    assert tr.cfg.blend_cap <= tr.cfg.isect_capacity
    assert tr.bsz == 2 and tr.lambda_dssim == 0.2
    s = np.sqrt(np.float32(2.0))
    np.testing.assert_allclose(tr.lrs.sh_dc, 0.0025 * s, rtol=1e-7)
    np.testing.assert_allclose(tr.xyz_sched.lr_init, 1.6e-4 * s, rtol=1e-7)
    np.testing.assert_allclose(float(tr.xyz_sched(0)), 1.6e-4 * s, rtol=1e-6)
    assert float(tr.bg.abs().sum()) == 0.0
