"""The projection layer's entry point and its kernel pair
(csrc/projection.cu), held to the plain version.

On the CPU: ``ops.projection.project_params`` takes the plain path
(``activated`` then ``project_gaussians_batched``) and gives its outputs
and gradients bit for bit; every caller of the layer goes through it; the
kernels' names stay clear of what the benchmark's roofline readers match.

On the card (tests marked ``card``; they skip without a CUDA device): the
kernel pair against the plain version on one scene that holds dead slots,
Gaussians behind the near plane and off screen, covariances that are not
positive definite (scales whose squares overflow), tangents clamped by the
Jacobian's limits and colours that ``sh_to_rgb`` clamps, at SH degrees 0-3
with K = 16, B = 1 and B = 8, and scale modifiers 1 and 0.7. This file
imports no JAX, so it runs on a machine without it, from the repository's
root:

    python -m pytest --noconftest -q tests/test_torch_projection_kernel.py

Tolerances (card): radii are equal on every slot, and depths and
opacities too (the kernel forms every product and sum of the plain
version in its order); means2d, conics and colours within 2e-6 of each
output's largest magnitude (the exp, sqrt and division of two compilations
of the same formulas). Gradients within 1e-4 of each leaf column's largest
magnitude: the kernel adds the cameras' terms of a Gaussian in camera
order in registers and multiplies the chain rule out in its own order,
where autograd adds each camera's graph in its order. Where a slot's
plain gradient is not finite (0 x inf in autograd, for a pair culled
because its covariance overflowed) the kernel gives 0.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from grendel_tpu_torch.cameras import batch_camera_arrays
from grendel_tpu_torch.convert import params_from_numpy
from grendel_tpu_torch.engine import render
from grendel_tpu_torch.models.gaussian_model import GaussianParams, activated
from grendel_tpu_torch.ops import projection
from grendel_tpu_torch.ops.projection import (ProjectedSplats,
                                              project_gaussians,
                                              project_gaussians_batched,
                                              project_params)
from grendel_tpu_torch.parallel import sharded
from grendel_tpu_torch.testing import (make_test_camera, params_fields,
                                       random_gaussians)

ROOT = Path(__file__).resolve().parents[1]
H, W = 120, 160
FIELDS = ("means2d", "conics", "colors", "opacities")


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def edge_scene(device, n=3000, seed=0):
    """(params, alive): random Gaussians at SH degree 3 (K = 16), 96 dead
    padding slots and every edge case of the projection."""
    m, s, q, o, sh = random_gaussians(seed, n, extent=2.0, sh_degree=3,
                                      scale_range=(-4.0, -1.5))
    rng = np.random.default_rng(seed + 1)
    m[:100, 2] = rng.uniform(-9.0, -6.0, 100)        # behind the near plane
    m[100:200, 0] = rng.uniform(15.0, 30.0, 100)     # far off screen
    # squares of the scales overflow: the 2D covariance is not finite, its
    # determinant not positive, and the pair is culled
    s[200:220, 0] = np.float32(np.exp(50.0))
    # beside the frustum and wide enough to reach the image: the
    # Jacobian's tangents clamped
    z = 4.0 - m[300:400, 2]
    m[300:350, 0] = (0.75 + 0.3 * rng.random(50)) * z[:50]
    m[350:400, 1] = (0.6 + 0.3 * rng.random(50)) * z[50:]
    s[300:400] = np.exp(rng.uniform(-1.0, 0.0, (100, 3)))
    sh[400:500, 0, :] = -3.0                         # colours clamped at 0
    sh[400:500, 1:, :] *= 20.0
    fields, alive = params_fields(m, s, q, o, sh, n + 96)
    alive[500:560] = False                           # dead slots
    return params_from_numpy(fields, alive, device)


def cameras(bsz, device):
    return batch_camera_arrays(
        [make_test_camera(W, H, dist=4.0, angle=0.35 * i)
         for i in range(bsz)], device)


def plain(params, alive, cams, sh_degree, scale_modifier):
    """The plain version, one camera at a time, with a scale modifier."""
    act = activated(params)
    per_cam = [project_gaussians(act.means3d, act.scales, act.quats,
                                 act.opacities, act.sh, alive, vm, fp, cp,
                                 tf, H, W, sh_degree,
                                 scale_modifier=scale_modifier)
               for vm, fp, cp, tf in zip(*cams)]
    return ProjectedSplats(*(torch.stack(x) for x in zip(*per_cam)))


def cotangents(splats, seed=3):
    """Random cotangents of means2d, conics, colors and opacities, zero
    for every pair whose radius is 0, as the render path sends them."""
    rng = np.random.default_rng(seed)
    vis = (splats.radii > 0).to(torch.float32)
    out = []
    for k in FIELDS:
        x = getattr(splats, k)
        c = torch.tensor(rng.standard_normal(tuple(x.shape)),
                         dtype=torch.float32, device=x.device)
        out.append(c * (vis[..., None] if c.dim() == 3 else vis))
    return out


def leaves_of(params):
    return GaussianParams(*(p.detach().clone().requires_grad_(True)
                            for p in params))


def same_bits(x, y):
    """Equal bit for bit, NaNs included."""
    x, y = x.detach(), y.detach()
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return x.shape == y.shape and torch.equal(x, y)


def grads_of(splats, leaves, cts):
    total = sum((getattr(splats, k) * c).sum() for k, c in zip(FIELDS, cts))
    return torch.autograd.grad(total, list(leaves))


# --------------------------------------------------------------------------
# on the CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bsz", [1, 3])
def test_entry_is_the_plain_path_on_the_cpu(bsz):
    """On CPU tensors the entry point gives the plain version's outputs
    and gradients bit for bit."""
    params, alive = edge_scene("cpu", n=600)
    cams = cameras(bsz, "cpu")
    a, b = leaves_of(params), leaves_of(params)
    got = project_params(a, alive, cams, H, W, 3)
    act = activated(b)
    want = project_gaussians_batched(act.means3d, act.scales, act.quats,
                                     act.opacities, act.sh, alive, cams, H,
                                     W, 3)
    for x, y in zip(got, want):
        assert same_bits(x, y)
    cts = cotangents(want)
    for x, y in zip(grads_of(got, a, cts), grads_of(want, b, cts)):
        assert same_bits(x, y)


def _scene_for(caller):
    params, alive = edge_scene("cpu", n=600)
    cfg = render.RenderConfig(img_h=H, img_w=W, isect_capacity=1 << 14)
    if caller == "render_image":
        one = cameras(1, "cpu")
        cam = type(one)(*(x[0] for x in one))
        return lambda: render.render_image(params, alive, cam, 3, cfg)
    if caller == "render_batch":
        return lambda: render.render_batch(params, alive, cameras(2, "cpu"),
                                           3, cfg)
    pcfg = sharded.ParallelConfig(n_devices=1, bsz=2, img_h=H, img_w=W)
    return lambda: sharded.project_batch(params, alive, cameras(2, "cpu"),
                                         pcfg, 3)


@pytest.mark.parametrize("caller",
                         ["render_image", "render_batch", "project_batch"])
def test_every_caller_goes_through_the_entry_point(caller, monkeypatch):
    """render_image, render_batch and the distributed step's project_batch
    each project through ``project_params``, once a call."""
    run = _scene_for(caller)
    calls = []

    def counted(*args, **kw):
        calls.append(args[2].viewmat.shape)
        return project_params(*args, **kw)

    module = sharded if caller == "project_batch" else render
    monkeypatch.setattr(module, "project_params", counted)
    run()
    assert len(calls) == 1
    assert len(calls[0]) == 3          # the cameras arrive batched


def _kernel_names():
    src = (ROOT / "grendel_tpu_torch" / "csrc" / "projection.cu").read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                      r"(\w+)", src)


def test_kernel_names_avoid_the_roofline_readers():
    """The benchmark's roofline readers count every kernel whose name
    holds one of their substrings; the projection kernels hold none."""
    import importlib

    names = _kernel_names()
    assert names == ["project_fwd_kernel", "project_bwd_kernel"]
    readers = sorted((ROOT / "gsbench" / "metrics").glob("*_roofline.py"))
    assert readers
    for path in readers:
        mod = importlib.import_module(f"gsbench.metrics.{path.stem}")
        for sub in mod.KERNELS:
            assert not any(sub in name for name in names), (path.stem, sub)


def test_project_cuda_refuses_a_cpu_tensor():
    params, alive = edge_scene("cpu", n=600)
    with pytest.raises(ValueError, match="no projection kernel"):
        projection.project_cuda(params, alive, cameras(1, "cpu"), H, W, 3)


def test_the_scene_holds_every_edge_case():
    """The card tests' scene, through the plain version on the CPU: dead
    slots, Gaussians behind the camera and off screen, covariances that
    are not finite, clamped tangents on visible pairs and clamped colours
    on visible pairs, all present."""
    params, alive = edge_scene("cpu")
    cams = cameras(8, "cpu")
    with torch.no_grad():
        s = plain(params, alive, cams, 3, 1.0)
    r = s.radii
    assert (r[:, ~alive] == 0).all() and (~alive).sum() >= 60 + 96
    assert (r[0, :100] == 0).all()                        # behind camera 0
    assert (r[0, 100:200] == 0).all()                     # off its screen
    assert (r[:, 200:220] == 0).all()                     # not finite
    assert not torch.isfinite(s.conics[:, 200:220]).all()
    # tangents past the Jacobian's limits on visible pairs
    m = params.means3d
    pv = torch.einsum("bij,nj->bni", cams.viewmat[:, :3, :3], m) \
        + cams.viewmat[:, None, :3, 3]
    lim = 1.3 * cams.tanfov[:, None, :]
    clamped = ((pv[..., :2] / pv[..., 2:3]).abs() > lim).any(-1)
    assert (clamped & (r > 0)).sum() > 50
    assert ((s.colors == 0).any(-1) & (r > 0)).sum() > 50
    assert (r > 0).sum() > 10000


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


def _close(got, want, what, rel):
    """|got - want| <= rel x the largest finite |want|; non-finite values
    in the same places and equal."""
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got)), what
    assert torch.equal(got[~fin].nan_to_num(), want[~fin].nan_to_num()), what
    if fin.any():
        scale = want[fin].abs().max().clamp_min(1e-30)
        err = (got[fin] - want[fin]).abs().max() / scale
        assert err <= rel, f"{what}: {float(err):.3g} of the largest value"


@pytest.mark.card
@pytest.mark.parametrize("scale_modifier", [1.0, 0.7])
@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
@pytest.mark.parametrize("bsz", [1, 8])
def test_kernel_matches_the_plain_version(card, bsz, sh_degree,
                                          scale_modifier):
    params, alive = edge_scene(card)
    cams = cameras(bsz, card)
    a, b = leaves_of(params), leaves_of(params)
    got = projection.project_cuda(a, alive, cams, H, W, sh_degree,
                                  scale_modifier)
    want = plain(b, alive, cams, sh_degree, scale_modifier)
    torch.cuda.synchronize()
    n_diff = int((got.radii != want.radii).sum())
    assert n_diff == 0, f"{n_diff} radii differ"
    assert torch.equal(got.depths, want.depths)
    assert torch.equal(got.opacities, want.opacities.detach())
    for k in ("means2d", "conics", "colors"):
        _close(getattr(got, k).detach(), getattr(want, k).detach(), k, 2e-6)

    cts = cotangents(want)
    g_got = grads_of(got, a, cts)
    g_want = grads_of(want, b, cts)
    torch.cuda.synchronize()
    for name, x, y in zip(GaussianParams._fields, g_got, g_want):
        x2, y2 = x.reshape(x.shape[0], -1), y.reshape(y.shape[0], -1)
        fin = torch.isfinite(y2).all(1)
        assert torch.isfinite(x2).all(), name
        # only the slots whose covariance overflowed have a non-finite
        # plain gradient; the kernel gives them none
        assert (~fin[:200]).sum() == 0 and (~fin[220:]).sum() == 0, name
        assert (x2[~fin] == 0).all(), name
        scale = y2[fin].abs().amax(0).clamp_min(1e-30)
        err = ((x2[fin] - y2[fin]).abs() / scale).max()
        assert err <= 1e-4, f"{name}: {float(err):.3g} of the column's largest"


@pytest.mark.card
def test_kernel_launches_once_a_call_each_way(card):
    """One forward launch a call, whatever B, and one backward launch."""
    params, alive = edge_scene(card, n=600)
    a = leaves_of(params)
    f0, b0 = projection.project_cuda.launches, \
        projection.project_cuda_vjp.launches
    s = project_params(a, alive, cameras(8, card), H, W, 3)
    grads_of(s, a, cotangents(s))
    assert projection.project_cuda.launches - f0 == 1
    assert projection.project_cuda_vjp.launches - b0 == 1


@pytest.mark.card
def test_backward_is_deterministic(card):
    params, alive = edge_scene(card)
    cams = cameras(8, card)
    runs = []
    for _ in range(2):
        a = leaves_of(params)
        s = projection.project_cuda(a, alive, cams, H, W, 3)
        runs.append(grads_of(s, a, cotangents(s)))
    for x, y in zip(*runs):
        assert torch.equal(x, y)
