"""Port parity: project_gaussians of grendel_tpu_torch against grendel_tpu
on one numpy scene that holds live, dead, behind-camera and off-screen
Gaussians.

Tolerance: means2d, conics and colors agree to rtol=atol=1e-5 (float32
formulas evaluated by two libraries: last-ulp differences, amplified by the
pixel scale of the means); radii (integers) agree exactly; depths agree at
rtol 1e-6 and hold +inf at the same places.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from grendel_tpu.cameras import batch_camera_arrays as j_batch_cams
from grendel_tpu.cameras import camera_arrays as j_cam
from grendel_tpu.ops.projection import project_gaussians as j_project
from grendel_tpu.ops.projection import project_gaussians_batched as j_project_b
from grendel_tpu_torch.cameras import batch_camera_arrays, camera_arrays
from grendel_tpu_torch.ops.projection import (project_gaussians,
                                              project_gaussians_batched)
from grendel_tpu_torch.testing import make_test_camera, random_gaussians

H, W = 64, 96
_j_project1 = jax.jit(j_project, static_argnums=(10, 11, 12))
_j_project_b1 = jax.jit(j_project_b, static_argnums=(7, 8, 9))


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores; torch's spinning intra-op
    threads would then slow every test on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed=0, n=400):
    means, scales, quats, opac, sh = random_gaussians(seed, n, sh_degree=3)
    rng = np.random.default_rng(seed + 100)
    means[:20, 2] = rng.uniform(-9.0, -6.0, 20)     # behind the camera
    means[20:40, 0] = rng.uniform(15.0, 30.0, 20)   # far off screen
    alive = np.ones(n, bool)
    alive[40:60] = False                            # dead slots
    return means, scales, quats, opac, sh, alive


def _check(t, j):
    for name in ("means2d", "conics", "colors"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(t.radii.numpy(), np.asarray(j.radii))
    np.testing.assert_array_equal(t.opacities.numpy() == 0,
                                  np.asarray(j.opacities) == 0)
    np.testing.assert_allclose(t.opacities.numpy(), np.asarray(j.opacities),
                               rtol=1e-6, atol=0)
    td, jd = t.depths.numpy(), np.asarray(j.depths)
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    np.testing.assert_allclose(td[np.isfinite(td)], jd[np.isfinite(jd)],
                               rtol=1e-6)


def test_project_gaussians_matches_jax():
    means, scales, quats, opac, sh, alive = _scene()
    cam = make_test_camera(W, H, dist=4.0)
    tc, jc = camera_arrays(cam, device="cpu"), j_cam(cam)
    t = project_gaussians(*(torch.tensor(x) for x in (means, scales, quats,
                                                        opac, sh, alive)),
                          tc.viewmat, tc.full_proj, tc.campos, tc.tanfov,
                          H, W, 3)
    j = _j_project1(*(jnp.asarray(x) for x in (means, scales, quats, opac,
                                                sh, alive)),
                    jc.viewmat, jc.full_proj, jc.campos, jc.tanfov, H, W, 3)
    _check(t, j)
    radii = t.radii.numpy()
    # the scene exercises every cull: dead, behind, off screen, and visible
    assert (radii[:60] == 0).all() and (radii[60:] > 0).sum() > 200
    assert np.isinf(t.depths.numpy()[:60]).all()


def test_project_gaussians_vjp_matches_jax():
    """The autograd VJP of project_gaussians against jax.vjp, for every
    float input (the five Gaussian inputs and the four camera arrays), with
    random cotangents on every float output. Tolerance: rtol = atol = 1e-5
    after scaling each gradient column by its largest value."""
    means, scales, quats, opac, sh, alive = _scene()
    cam = make_test_camera(W, H, dist=4.0)
    tc, jc = camera_arrays(cam, device="cpu"), j_cam(cam)
    gauss = (means, scales, quats, opac, sh)
    cam_np = [np.asarray(x) for x in (jc.viewmat, jc.full_proj, jc.campos,
                                      jc.tanfov)]
    outs = ("means2d", "conics", "colors", "opacities", "depths")

    def f_j(*xs):
        s = j_project(*xs[:5], jnp.asarray(alive), *xs[5:], H, W, 3)
        return tuple(getattr(s, k) for k in outs)

    primals = [jnp.asarray(x) for x in gauss + tuple(cam_np)]
    j_out, vjp = jax.vjp(f_j, *primals)
    rng = np.random.default_rng(9)
    cts = [rng.standard_normal(np.shape(o)).astype(np.float32)
           for o in j_out]
    g_j = vjp(tuple(jnp.asarray(c) for c in cts))

    leaves = [torch.tensor(np.asarray(x), requires_grad=True)
              for x in gauss + tuple(cam_np)]
    s = project_gaussians(*leaves[:5], torch.tensor(alive), *leaves[5:],
                          H, W, 3)
    total = sum((getattr(s, k) * torch.tensor(c)).where(
        torch.isfinite(getattr(s, k)), torch.zeros(())).sum()
        for k, c in zip(outs, cts))
    g_t = torch.autograd.grad(total, leaves)
    names = ("means3d", "scales", "quats", "opacities", "sh", "viewmat",
             "full_proj", "campos", "tanfov")
    for name, a, b in zip(names, g_t, g_j):
        a2 = a.numpy().reshape(a.shape[0], -1)
        b2 = np.asarray(b).reshape(a2.shape)
        scale = np.abs(b2).max(axis=0) + 1e-30
        assert np.isfinite(a2).all(), name
        np.testing.assert_allclose(a2 / scale, b2 / scale, rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_project_gaussians_batched_matches_jax():
    means, scales, quats, opac, sh, alive = _scene(seed=5, n=200)
    cams = [make_test_camera(W, H, dist=4.0, angle=0.4 * i) for i in range(2)]
    tc = batch_camera_arrays(cams, device="cpu")
    t = project_gaussians_batched(
        *(torch.tensor(x) for x in (means, scales, quats, opac, sh, alive)),
        tc, H, W, 2)
    j = _j_project_b1(*(jnp.asarray(x) for x in (means, scales, quats, opac,
                                                  sh, alive)),
                      j_batch_cams(cams), H, W, 2)
    assert t.means2d.shape == (2, 200, 2)
    _check(t, j)
