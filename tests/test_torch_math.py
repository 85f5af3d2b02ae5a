"""Port parity: math3d, spherical harmonics, cameras and the Gaussian model
of grendel_tpu_torch against grendel_tpu, on the same numpy inputs.

Tolerance: atol=1e-6 on float32 values of order one; both sides compute
the same formulas in float32, in the same order up to reassociation by
the two libraries' elementwise kernels.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from grendel_tpu import cameras as jcams
from grendel_tpu.models import gaussian_model as jgm
from grendel_tpu.ops import sh as jsh
from grendel_tpu.utils import math3d as jm3
from grendel_tpu_torch import cameras as tcams
from grendel_tpu_torch.convert import params_from_numpy
from grendel_tpu_torch.models import gaussian_model as tgm
from grendel_tpu_torch.ops import sh as tsh
from grendel_tpu_torch.testing import (make_test_camera, params_fields,
                                       random_gaussians)
from grendel_tpu_torch.utils import math3d as tm3

ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores; torch's spinning intra-op
    threads would then slow every test on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol, rtol=0)


def _quats(seed=0, n=64):
    return np.random.default_rng(seed).standard_normal((n, 4)).astype(np.float32)


def test_quat_rotmat_matches_jax():
    q = _quats()
    _close(tm3.quat_to_rotmat(torch.tensor(q)), jm3.quat_to_rotmat(jnp.asarray(q)))
    for t, j in zip(tm3.quat_rotmat_entries(torch.tensor(q)),
                    jm3.quat_rotmat_entries(jnp.asarray(q))):
        _close(t, j)
    r = tm3.quat_to_rotmat(torch.tensor(q)).numpy()
    _close(r @ r.transpose(0, 2, 1), np.broadcast_to(np.eye(3), r.shape),
           atol=1e-5)


def test_camera_matrices_and_helpers_match_jax():
    rng = np.random.default_rng(1)
    r = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    t = rng.standard_normal(3)
    tr = rng.standard_normal(3)
    np.testing.assert_array_equal(tm3.world_to_view(r, t, tr, 1.3),
                                  jm3.world_to_view(r, t, tr, 1.3))
    np.testing.assert_array_equal(
        tm3.perspective_projection(0.01, 100.0, 1.1, 0.8),
        jm3.perspective_projection(0.01, 100.0, 1.1, 0.8))
    assert tm3.fov_to_focal(1.1, 640) == jm3.fov_to_focal(1.1, 640)
    assert tm3.focal_to_fov(500.0, 640) == jm3.focal_to_fov(500.0, 640)
    v = rng.uniform(-1, 1, 32).astype(np.float32)
    _close(tm3.ndc_to_pixel(torch.tensor(v), 97),
           jm3.ndc_to_pixel(jnp.asarray(v), 97))
    x = rng.uniform(0.01, 0.99, 32).astype(np.float32)
    _close(tm3.inverse_sigmoid(torch.tensor(x)),
           jm3.inverse_sigmoid(jnp.asarray(x)))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    sh = rng.standard_normal((50, 16, 3)).astype(np.float32)
    d = rng.standard_normal((50, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    _close(tsh.eval_sh(degree, torch.tensor(sh), torch.tensor(d)),
           jsh.eval_sh(degree, jnp.asarray(sh), jnp.asarray(d)))
    _close(tsh.sh_to_rgb(degree, torch.tensor(sh), torch.tensor(d)),
           jsh.sh_to_rgb(degree, jnp.asarray(sh), jnp.asarray(d)))


def test_sh_dc_mappings_match_jax():
    rgb = np.random.default_rng(7).uniform(0, 1, (20, 3)).astype(np.float32)
    _close(tsh.rgb_to_sh(torch.tensor(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))
    _close(tsh.sh_to_rgb_dc(torch.tensor(rgb)),
           jsh.sh_to_rgb_dc(jnp.asarray(rgb)))


def test_camera_arrays_match_jax():
    cams = [make_test_camera(96, 64, dist=4.5, angle=0.3 * i) for i in range(3)]
    t = tcams.batch_camera_arrays(cams, device="cpu")
    j = jcams.batch_camera_arrays(cams)
    for name in ("viewmat", "full_proj", "campos", "tanfov"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    one = tcams.camera_arrays(cams[1], device="cpu")
    np.testing.assert_array_equal(one.full_proj.numpy(),
                                  np.asarray(jcams.camera_arrays(cams[1]).full_proj))


def test_activated_and_capacity_helpers_match_jax():
    fields, alive = params_fields(*random_gaussians(3, 40, sh_degree=2), 64)
    tp, ta = params_from_numpy(fields, alive, "cpu")
    jp = jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in fields.items()})
    for t, j in zip(tgm.activated(tp), jgm.activated(jp)):
        _close(t, j)
    assert int(tgm.count_alive(ta)) == int(jgm.count_alive(jnp.asarray(alive)))
    assert tgm.round_capacity(1000) == jgm.round_capacity(1000)
    tg, tga = tgm.pad_to_capacity(tp, ta, 96)
    jg, jga = jgm.pad_to_capacity(jp, jnp.asarray(alive), 96)
    for t, j in zip(tg, jg):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tga.numpy(), np.asarray(jga))
    for t, j in zip(tgm.empty_params(8, 2, device="cpu"), jgm.empty_params(8, 2)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
