"""Port parity of densification and model initialization:
grendel_tpu_torch's densify_and_prune, reset_opacity, init_from_pcd,
pad_to_capacity and mean_dist2_to_knn against grendel_tpu's on the same
numpy inputs.

densify_and_prune takes the split noise as an argument; each case passes
in the draw JAX's densify_and_prune makes from its key,
``jax.random.normal(key, (n, 2, 3))``. Tolerances: alive masks and the
info counts exact; parameters and Adam moments within 1e-6 of each leaf's
largest absolute value (the same float32 operations in two libraries);
the statistics come back zero.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from grendel_tpu.models import densify as JD
from grendel_tpu.models import gaussian_model as JG
from grendel_tpu.models.optimizer import AdamState as JAdam
from grendel_tpu.ops import knn as JK
from grendel_tpu_torch.models import densify as TD
from grendel_tpu_torch.models import gaussian_model as TG
from grendel_tpu_torch.models.optimizer import AdamState as TAdam
from grendel_tpu_torch.ops import knn as TK

FIELDS = TG.GaussianParams._fields


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores; torch's spinning intra-op
    threads would then slow every test on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _simple(n, scale=0.01):
    """tests/test_model.py's _simple_params as numpy fields."""
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    return dict(
        means3d=np.arange(n * 3, dtype=np.float32).reshape(n, 3),
        sh_dc=np.zeros((n, 1, 3), np.float32),
        sh_rest=np.zeros((n, 15, 3), np.float32),
        scales_raw=np.full((n, 3), np.log(scale), np.float32),
        quats=quats,
        opacities_raw=np.full((n,), 2.0, np.float32))


def _zeros_like(fields):
    return {k: np.zeros_like(v) for k, v in fields.items()}


def _case_clone():
    n = 8
    f = _simple(n)
    mu = _zeros_like(f)
    mu["means3d"] = np.ones((n, 3), np.float32)
    grad = np.array([0, 1, 0, 0, 0, 0, 0, 0], np.float32)
    return dict(fields=f, alive=np.arange(n) < 4, mu=mu, nu=_zeros_like(f),
                stats=(grad, np.ones(n, np.float32), np.zeros(n, np.float32)),
                size_prune=False, seed=0)


def _case_split():
    n = 8
    f = _simple(n, scale=1.0)
    nu = _zeros_like(f)
    nu["scales_raw"] = np.ones((n, 3), np.float32)
    grad = np.array([0, 0, 1, 0, 0, 0, 0, 0], np.float32)
    return dict(fields=f, alive=np.arange(n) < 3, mu=_zeros_like(f), nu=nu,
                stats=(grad, np.ones(n, np.float32), np.zeros(n, np.float32)),
                size_prune=False, seed=1)


def _case_prune_opacity():
    n = 8
    f = _simple(n)
    f["opacities_raw"][0] = -10.0
    z = np.zeros(n, np.float32)
    return dict(fields=f, alive=np.arange(n) < 4, mu=_zeros_like(f),
                nu=_zeros_like(f), stats=(z, z, z), size_prune=False, seed=2)


def _case_size_prune():
    n = 8
    f = _simple(n, scale=5.0)
    z = np.zeros(n, np.float32)
    return dict(fields=f, alive=np.arange(n) < 4, mu=_zeros_like(f),
                nu=_zeros_like(f), stats=(z, z, z), size_prune=True, seed=3)


def _case_overflow():
    n = 4
    f = _simple(n)
    one = np.ones(n, np.float32)
    return dict(fields=f, alive=np.ones(n, bool), mu=_zeros_like(f),
                nu=_zeros_like(f), stats=(one, one, np.zeros(n, np.float32)),
                size_prune=False, seed=4)


def _case_random(n=4096, alive_frac=0.6, size_prune=True, seed=5):
    """Random mid-size state: clones, splits, opacity and size prunes,
    unseen Gaussians (denom 0), live moments everywhere."""
    rng = np.random.default_rng(seed)
    f = dict(
        means3d=rng.uniform(-2, 2, (n, 3)),
        sh_dc=rng.normal(size=(n, 1, 3)),
        sh_rest=0.1 * rng.normal(size=(n, 15, 3)),
        # max scale straddles percent_dense * extent = 0.03 and, for a few,
        # the size prune at 0.1 * extent = 0.3
        scales_raw=rng.uniform(np.log(0.003), np.log(0.5), (n, 3)),
        quats=rng.normal(size=(n, 4)),
        opacities_raw=rng.uniform(-7.0, 3.0, n))
    f = {k: v.astype(np.float32) for k, v in f.items()}
    mu = {k: (1e-3 * rng.normal(size=v.shape)).astype(np.float32)
          for k, v in f.items()}
    nu = {k: (1e-6 * rng.uniform(size=v.shape)).astype(np.float32)
          for k, v in f.items()}
    denom = rng.integers(0, 6, n).astype(np.float32)
    grad = (denom * rng.uniform(0, 4e-4, n)).astype(np.float32)
    max_r = rng.integers(0, 20, n).astype(np.float32)
    return dict(fields=f, alive=rng.random(n) < alive_frac, mu=mu, nu=nu,
                stats=(grad, denom, max_r), size_prune=size_prune, seed=seed)


CASES = {
    "clone_to_free_slot": (_case_clone, dict(extent=10.0, thr=0.5)),
    "split": (_case_split, dict(extent=10.0, thr=0.5)),
    "prune_by_opacity": (_case_prune_opacity, dict(extent=10.0, thr=0.5)),
    "size_prune": (_case_size_prune, dict(extent=10.0, thr=0.5)),
    "overflow_drops": (_case_overflow, dict(extent=10.0, thr=0.5)),
    "random": (_case_random, dict(extent=3.0, thr=2e-4)),
    "random_overflow": (lambda: _case_random(alive_frac=0.9, size_prune=False,
                                             seed=6),
                        dict(extent=3.0, thr=2e-4)),
}


def _jax_tree(d):
    return JG.GaussianParams(**{k: jnp.asarray(d[k]) for k in FIELDS})


def _torch_tree(d):
    return TG.GaussianParams(**{k: torch.from_numpy(np.array(d[k]))
                                for k in FIELDS})


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-6,
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_densify_and_prune_matches_jax(name):
    make, kw = CASES[name]
    c = make()
    n = c["alive"].shape[0]
    grad, denom, max_r = c["stats"]
    key = jax.random.key(c["seed"])
    noise = np.array(jax.random.normal(key, (n, JD.SPLIT_N, 3)))
    args = (kw["thr"], 0.005, kw["extent"], 0.01, c["size_prune"])

    jp, ja, jadam, jst, jinfo = JD.densify_and_prune(
        _jax_tree(c["fields"]), jnp.asarray(c["alive"]),
        JAdam(mu=_jax_tree(c["mu"]), nu=_jax_tree(c["nu"]),
              count=jnp.int32(3)),
        JD.DensifyStats(jnp.asarray(grad), jnp.asarray(denom),
                        jnp.asarray(max_r)),
        key, *args)
    tp, ta, tadam, tst, tinfo = TD.densify_and_prune(
        _torch_tree(c["fields"]), torch.from_numpy(c["alive"]),
        TAdam(mu=_torch_tree(c["mu"]), nu=_torch_tree(c["nu"]),
              count=torch.tensor(3, dtype=torch.int32)),
        TD.DensifyStats(*(torch.from_numpy(x) for x in (grad, denom, max_r))),
        torch.from_numpy(noise), *args)

    want_info = [int(x) for x in jinfo]
    assert tinfo.dtype == torch.int32 and tinfo.shape == (5,)
    assert TD.DensifyInfo(*tinfo.tolist()) == TD.DensifyInfo(*want_info)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for k in FIELDS:
        _close(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)), k)
        _close(getattr(tadam.mu, k).numpy(), np.asarray(getattr(jadam.mu, k)),
               f"mu {k}")
        _close(getattr(tadam.nu, k).numpy(), np.asarray(getattr(jadam.nu, k)),
               f"nu {k}")
    assert int(tadam.count) == 3
    for x in tst:
        assert x.shape == (n,) and float(x.abs().sum()) == 0.0
    if name.startswith("random"):
        # the random cases reach every branch
        info = TD.DensifyInfo(*want_info)
        assert info.n_cloned > 0 and info.n_split > 0 and info.n_pruned > 0
        assert (info.n_dropped > 0) == (name == "random_overflow")


def test_densify_rejects_noise_of_the_wrong_shape():
    c = _case_clone()
    st = TD.densify_stats_init(8, "cpu")
    p = _torch_tree(c["fields"])
    with pytest.raises(ValueError, match="noise"):
        TD.densify_and_prune(p, torch.from_numpy(c["alive"]),
                             TAdam(p, p, torch.tensor(0)), st,
                             torch.zeros(8, 3), 0.5, 0.005, 10.0, 0.01, False)


def test_reset_opacity_matches_jax():
    c = _case_random(n=512, seed=9)
    jp, jadam = JD.reset_opacity(
        _jax_tree(c["fields"]),
        JAdam(mu=_jax_tree(c["mu"]), nu=_jax_tree(c["nu"]),
              count=jnp.int32(5)))
    tp, tadam = TD.reset_opacity(
        _torch_tree(c["fields"]),
        TAdam(mu=_torch_tree(c["mu"]), nu=_torch_tree(c["nu"]),
              count=torch.tensor(5, dtype=torch.int32)))
    for k in FIELDS:
        _close(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)), k)
        for name in ("mu", "nu"):
            np.testing.assert_array_equal(
                getattr(getattr(tadam, name), k).numpy(),
                np.asarray(getattr(getattr(jadam, name), k)))
    assert float(torch.sigmoid(tp.opacities_raw).max()) <= 0.01 + 1e-7


@pytest.mark.parametrize("n_shards", [1, 3])
def test_init_from_pcd_matches_jax(n_shards):
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(1000, 3)).astype(np.float32)
    cols = rng.uniform(size=(1000, 3)).astype(np.float32)
    cap = 1536
    jp, ja = JG.init_from_pcd(pts, cols, cap, 3, n_shards=n_shards)
    tp, ta = TG.init_from_pcd(pts, cols, cap, 3, n_shards=n_shards,
                              device="cpu")
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert int(TG.count_alive(ta)) == int(JG.count_alive(ja)) == 1000
    for k in FIELDS:
        _close(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)), k)
    with pytest.raises(ValueError, match="exceeds capacity"):
        TG.init_from_pcd(pts, cols, 512, device="cpu")


def test_mean_dist2_to_knn_matches_jax():
    rng = np.random.default_rng(12)
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    want = JK.mean_dist2_to_knn(pts, k=3)
    np.testing.assert_array_equal(TK.mean_dist2_to_knn(pts, k=3), want)
    np.testing.assert_allclose(TK._brute_force_knn(pts, 3, chunk=256),
                               JK._brute_force_knn(pts, 3, chunk=256),
                               rtol=1e-6)
    np.testing.assert_allclose(TK._brute_force_knn(pts, 3), want, rtol=1e-4,
                               atol=1e-6)
    assert TK.mean_dist2_to_knn(pts[:1]).tolist() == [np.float32(1e-7)]


def test_pad_to_capacity_matches_jax():
    c = _case_random(n=300, seed=13)
    jp, ja = JG.pad_to_capacity(_jax_tree(c["fields"]),
                                jnp.asarray(c["alive"]), 512)
    tp, ta = TG.pad_to_capacity(_torch_tree(c["fields"]),
                                torch.from_numpy(c["alive"]), 512)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)
    assert TG.round_capacity(300) == JG.round_capacity(300) == 512
    with pytest.raises(ValueError, match="shrink"):
        TG.pad_to_capacity(tp, ta, 256)
