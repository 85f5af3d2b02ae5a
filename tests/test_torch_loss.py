"""Port parity of the loss: ssim_map, camera_loss (with and without a
mask), batch_loss and psnr of grendel_tpu_torch against grendel_tpu, and
their gradients against jax.grad, on numpy images.

Tolerances: values 1e-6, gradients 1e-5 (absolute and relative): the same
float32 formulas, summed in two libraries' orders.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from grendel_tpu.engine import loss as JL
from grendel_tpu.ops import ssim as JS
from grendel_tpu_torch.engine import loss as TL
from grendel_tpu_torch.ops import ssim as TS


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores; torch's spinning intra-op
    threads would then slow every test on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed, shape):
    """A rendered-like image and a ground truth near it, in [0, 1]."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(
        np.float32)
    return a, b


def _close(t, j, tol=1e-6):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol,
                               rtol=tol)


def test_window_and_ssim_map_match_jax():
    _close(TS.gaussian_window(), JS.gaussian_window())
    a, b = _images(0, (3, 40, 56))
    _close(TS.ssim_map(torch.tensor(a), torch.tensor(b)),
           JS.ssim_map(jnp.asarray(a), jnp.asarray(b)))
    _close(TS.ssim(torch.tensor(a), torch.tensor(b)),
           JS.ssim(jnp.asarray(a), jnp.asarray(b)))
    _close(TS.l1_loss(torch.tensor(a), torch.tensor(b)),
           JS.l1_loss(jnp.asarray(a), jnp.asarray(b)))
    _close(TS.l2_loss(torch.tensor(a), torch.tensor(b)),
           JS.l2_loss(jnp.asarray(a), jnp.asarray(b)))
    _close(TS.psnr(torch.tensor(a), torch.tensor(b)),
           JS.psnr(jnp.asarray(a), jnp.asarray(b)))


def _grad_t(fn, x):
    xt = torch.tensor(x, requires_grad=True)
    out = fn(xt)
    (g,) = torch.autograd.grad(out, [xt])
    return out, g


@pytest.mark.parametrize("masked", [False, True])
def test_camera_loss_and_grad_match_jax(masked):
    a, b = _images(1, (3, 33, 47))
    mask = None
    if masked:
        mask = np.zeros((33, 47), bool)
        mask[5:20] = True                # a band of rows that count

    def f_t(x):
        m = None if mask is None else torch.tensor(mask)
        loss, l1, s = TL.camera_loss(x, torch.tensor(b), 0.2, m)
        return loss

    def f_j(x):
        m = None if mask is None else jnp.asarray(mask)
        return JL.camera_loss(x, jnp.asarray(b), 0.2, m)[0]

    v_t, g_t = _grad_t(f_t, a)
    v_j, g_j = jax.value_and_grad(f_j)(jnp.asarray(a))
    _close(v_t, v_j)
    _close(g_t, g_j, 1e-5)
    _, l1_t, s_t = TL.camera_loss(torch.tensor(a), torch.tensor(b), 0.2,
                                  None if mask is None else torch.tensor(mask))
    _, l1_j, s_j = JL.camera_loss(jnp.asarray(a), jnp.asarray(b), 0.2,
                                  None if mask is None else jnp.asarray(mask))
    _close(l1_t, l1_j)
    _close(s_t, s_j)


def test_batch_loss_and_grad_match_jax():
    a, b = _images(2, (2, 3, 48, 64))
    v_t, g_t = _grad_t(lambda x: TL.batch_loss(
        x, torch.tensor(b), 0.2, lr_scale_loss=1.5)[0], a)
    v_j, g_j = jax.value_and_grad(lambda x: JL.batch_loss(
        x, jnp.asarray(b), 0.2, lr_scale_loss=1.5)[0])(jnp.asarray(a))
    _close(v_t, v_j)
    _close(g_t, g_j, 1e-5)
    _, per_t = TL.batch_loss(torch.tensor(a), torch.tensor(b), 0.2)
    _, per_j = JL.batch_loss(jnp.asarray(a), jnp.asarray(b), 0.2)
    assert per_t.shape == (2, 2)
    _close(per_t, per_j)
    # the batch folded into the channel axis equals per-camera losses
    for i in range(2):
        loss_i, l1_i, s_i = TL.camera_loss(torch.tensor(a[i]),
                                           torch.tensor(b[i]), 0.2)
        _close(per_t[i], torch.stack([l1_i, s_i]).numpy())


def test_ssim_and_psnr_grads_match_jax():
    a, b = _images(3, (3, 24, 40))
    v_t, g_t = _grad_t(lambda x: TS.ssim(x, torch.tensor(b)), a)
    v_j, g_j = jax.value_and_grad(lambda x: JS.ssim(x, jnp.asarray(b)))(
        jnp.asarray(a))
    _close(v_t, v_j)
    _close(g_t, g_j, 1e-5)
    v_t, g_t = _grad_t(lambda x: TS.psnr(x, torch.tensor(b)), a)
    v_j, g_j = jax.value_and_grad(lambda x: JS.psnr(x, jnp.asarray(b)))(
        jnp.asarray(a))
    _close(v_t, v_j, 1e-5)     # ~20 dB: 1e-6 relative is 2e-5 absolute
    _close(g_t, g_j, 1e-5)
    # pixelwise masked maps
    m = np.zeros((24, 40), np.float32)
    m[3:9] = 1.0
    _close(TS.pixelwise_ssim_with_mask(torch.tensor(a), torch.tensor(b),
                                       torch.tensor(m)),
           JS.pixelwise_ssim_with_mask(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(m)))
    _close(TS.pixelwise_l1_with_mask(torch.tensor(a), torch.tensor(b),
                                     torch.tensor(m)),
           JS.pixelwise_l1_with_mask(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(m)))
