"""Port parity of the backward blend: rasterize_slots_bwd (the plain version
kernel K2 is held to on the card) against autograd through the plain
forward, and against jax.value_and_grad of grendel_tpu's Pallas blend in
interpret mode, on scenes rebuilt from numpy seeds.

Tolerances (each gradient column scaled by its largest value):
  * against autograd through the same plain forward: atol 1e-6 (the same
    f32 formulas; autograd sums the chain in another order);
  * against the Pallas blend, no pixel saturated: atol 2e-5, the JAX
    package's own bound between its two backends
    (tests/test_rasterize_pallas.py:84-88). The loss uses colors and
    final_t, so both cotangents are live;
  * on the saturating scene of seed 11: the include-flip bounds the JAX
    package applies between its two backends
    (tests/test_rasterize_pallas.py:333): at most 2% of values off by more
    than 1e-3, none by more than 0.2. The port stops a pixel at its first
    entry with T (1 - alpha) < 1e-4; the JAX walk decides per window.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from grendel_tpu.cameras import camera_arrays as j_cam
from grendel_tpu.ops.isect import isect_tiles as j_isect
from grendel_tpu.ops.projection import project_gaussians as j_project
from grendel_tpu.ops.rasterize_pallas import rasterize_slots_pl
from grendel_tpu_torch.ops.rasterize_cuda import (rasterize_slots_fwd,
                                                  rasterize_slots_vjp)
from grendel_tpu_torch.ops.rasterize_torch import (rasterize_slots,
                                                   rasterize_slots_bwd)
from grendel_tpu_torch.testing import make_test_camera, random_gaussians

TILE = 16
W, H = 64, 48
TX, TY = -(-W // TILE), -(-H // TILE)
NAMES = ("means2d", "conics", "colors", "opacities")


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores; torch's spinning intra-op
    threads would then slow every test on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@jax.jit
def _project(means, scales, quats, opac, sh, vm, fp, cp, tf):
    return j_project(means, scales, quats, opac, sh,
                     jnp.ones(means.shape[0], bool), vm, fp, cp, tf, H, W, 3)


_isect = jax.jit(j_isect, static_argnums=(3, 4, 5, 6, 7))


def _scene(n, seed, capacity=4096, opacity=None):
    """(means2d, conics, colors, opacities, gauss_ids, tile_offsets, px0,
    py0) as numpy: JAX-projected splats and JAX tile lists."""
    g = random_gaussians(seed, n, sh_degree=3)
    ca = j_cam(make_test_camera(width=W, height=H))
    s = _project(*(jnp.asarray(x) for x in g), ca.viewmat, ca.full_proj,
                 ca.campos, ca.tanfov)
    if opacity is not None:
        s = s._replace(opacities=jnp.full_like(s.opacities, opacity))
    isect = _isect(s.means2d, s.radii, s.depths, TILE, TILE, TX, TY, capacity)
    t_ids = np.arange(TX * TY, dtype=np.int32)
    px0, py0 = (t_ids % TX) * TILE, (t_ids // TX) * TILE
    return [np.asarray(x) for x in (s.means2d, s.conics, s.colors,
                                    s.opacities, isect.gauss_ids,
                                    isect.tile_offsets, px0, py0)]


def _spans(toff, blocked):
    if blocked:
        return dict(tile_offsets=None, tile_lo=toff[:-1], tile_hi=toff[1:])
    return dict(tile_offsets=toff)


def _port_bwd(args, mpt, blocked, t_weight, fn=rasterize_slots_bwd):
    """Port gradients of sum(c^2) + t_weight * sum(t^2) (cotangents
    2 c and 2 t_weight t), and the forward."""
    m2d, con, col, op, ids, toff, px0, py0 = (torch.tensor(a) for a in args)
    kw = _spans(toff, blocked)
    toff_arg = kw.pop("tile_offsets")
    c, t = rasterize_slots(m2d, con, col, op, ids, toff_arg, px0, py0, TILE,
                           TILE, mpt, **kw)
    grads = fn(m2d, con, col, op, ids, toff_arg, px0, py0, TILE, TILE, mpt,
               **kw, c_total=c, final_t=t, g=2.0 * c, g_t=2.0 * t_weight * t)
    return [x.numpy() for x in grads], c.numpy(), t.numpy()


def _pallas_grads(args, mpt, blocked, t_weight):
    m2d, con, col, op, ids, toff, px0, py0 = (jnp.asarray(a) for a in args)
    kw = _spans(toff, blocked)
    toff_arg = kw.pop("tile_offsets")

    def loss(m2d, con, col, op):
        c, t = rasterize_slots_pl(m2d, con, col, op, ids, toff_arg, px0, py0,
                                  TILE, TILE, mpt, interpret=True, **kw)
        return jnp.sum(c * c) + t_weight * jnp.sum(t * t)

    _, g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3)))(
        m2d, con, col, op)
    return [np.asarray(x) for x in g]


def _scaled_close(got, want, atol, what):
    """Each column of each gradient scaled by the column's largest value."""
    for name, a, b in zip(NAMES, got, want):
        a2, b2 = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
        scale = np.abs(b2).max(axis=0) + 1e-12
        np.testing.assert_allclose(a2 / scale, b2 / scale, atol=atol, rtol=0,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("n,seed,mpt,blocked", [
    (300, 0, 256, False),
    (300, 2, 256, True),
    (500, 1, 64, False),       # max_per_tile truncates deep tiles
])
def test_plain_bwd_matches_autograd(n, seed, mpt, blocked):
    args = _scene(n, seed)
    got, _, t = _port_bwd(args, mpt, blocked, 0.7)
    leaves = [torch.tensor(a, requires_grad=True) for a in args[:4]]
    ids, toff, px0, py0 = (torch.tensor(a) for a in args[4:])
    kw = _spans(toff, blocked)
    c2, t2 = rasterize_slots(*leaves, ids, kw.pop("tile_offsets"), px0, py0,
                             TILE, TILE, mpt, **kw)
    want = torch.autograd.grad((c2 * c2).sum() + 0.7 * (t2 * t2).sum(),
                               leaves)
    _scaled_close(got, [w.numpy() for w in want], 1e-6, "autograd")


@pytest.mark.parametrize("n,seed,mpt,blocked", [
    (300, 0, 256, False),
    (300, 0, 256, True),
    (500, 1, 64, False),       # max_per_tile truncates deep tiles
])
def test_plain_bwd_matches_pallas_unsaturated(n, seed, mpt, blocked):
    args = _scene(n, seed)
    if mpt == 64:
        assert (args[5][1:] - args[5][:-1]).max() > mpt
    got, _, t = _port_bwd(args, mpt, blocked, 0.7)
    # no pixel saturates, so the two stop rules coincide
    assert t.min() > 1e-2
    want = _pallas_grads(args, mpt, blocked, 0.7)
    _scaled_close(got, want, 2e-5, "pallas")


def _close_except_flips(a, b, atol, flip_frac, flip_bound, msg):
    diff = np.abs(np.asarray(a) - np.asarray(b))
    frac = float((diff > atol).mean())
    assert frac <= flip_frac, (msg, frac, diff.max())
    assert diff.max() <= flip_bound, (msg, diff.max())


def test_plain_bwd_matches_pallas_saturated():
    args = _scene(1200, 11, capacity=1 << 14, opacity=0.999)
    got, _, t = _port_bwd(args, 1024, False, 0.5)
    assert t.min() < 2e-4                          # saturation happened
    want = _pallas_grads(args, 1024, False, 0.5)
    for name, a, b in zip(NAMES, got, want):
        scale = np.abs(b).max() + 1e-8
        _close_except_flips(a / scale, b / scale, 1e-3, 0.02, 0.2, name)


def test_autograd_function_on_cpu_gives_the_plain_results():
    """The blend's autograd Function on CPU tensors runs the plain forward
    and rasterize_slots_bwd; the K2 wrapper on CPU tensors is that plain
    version too."""
    args = _scene(300, 3)
    want, c_p, t_p = _port_bwd(args, 256, True, 0.7)
    got_w, _, _ = _port_bwd(args, 256, True, 0.7, fn=rasterize_slots_vjp)
    for a, b in zip(got_w, want):
        np.testing.assert_array_equal(a, b)
    leaves = [torch.tensor(a, requires_grad=True) for a in args[:4]]
    ids, toff, px0, py0 = (torch.tensor(a) for a in args[4:])
    launches = rasterize_slots_vjp.launches
    c, t = rasterize_slots_fwd(*leaves, ids, None, px0, py0, TILE, TILE, 256,
                               tile_lo=toff[:-1], tile_hi=toff[1:])
    assert c.requires_grad and t.requires_grad
    np.testing.assert_array_equal(c.detach().numpy(), c_p)
    np.testing.assert_array_equal(t.detach().numpy(), t_p)
    got = torch.autograd.grad((c * c).sum() + 0.7 * (t * t).sum(), leaves)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    # CPU tensors never count as kernel launches
    assert rasterize_slots_vjp.launches == launches
