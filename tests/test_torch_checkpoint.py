"""Checkpoint interchange between grendel_tpu_torch and grendel_tpu: the
port reads checkpoint sets that grendel_tpu wrote (world sizes 1 and 2,
elastic and same-size), grendel_tpu reads the port's, both write the same
npz payload for one state, and find_latest_checkpoint and the tuner state
behave alike. Every comparison is exact: the format is float32 arrays
copied, never computed.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from grendel_tpu.engine import checkpoint as JC
from grendel_tpu.engine.train import TrainState as JState
from grendel_tpu.models.densify import densify_stats_init as j_stats_init
from grendel_tpu.models.gaussian_model import GaussianParams as JParams
from grendel_tpu.models.optimizer import AdamState as JAdam
from grendel_tpu_torch import convert, testing
from grendel_tpu_torch.config import TrainConfig
from grendel_tpu_torch.engine import checkpoint as TC
from grendel_tpu_torch.engine.trainer import Trainer

FIELDS = JParams._fields


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores; torch's spinning intra-op
    threads would then slow every test on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_state(seed, n=256, n_alive=150, iteration=40, count=20):
    """A training state as numpy leaves, with dead slots scattered."""
    rng = np.random.default_rng(seed)
    shapes = dict(means3d=(n, 3), sh_dc=(n, 1, 3), sh_rest=(n, 15, 3),
                  scales_raw=(n, 3), quats=(n, 4), opacities_raw=(n,))
    tree = lambda s: {k: (s * rng.normal(size=v)).astype(np.float32)
                      for k, v in shapes.items()}
    alive = np.zeros(n, bool)
    alive[rng.choice(n, n_alive, replace=False)] = True
    return dict(params=tree(1.0), mu=tree(1e-3), nu=tree(1e-6), alive=alive,
                iteration=iteration, count=count)


def _jax_state(s):
    tree = lambda d: JParams(**{k: jnp.asarray(d[k]) for k in FIELDS})
    return JState(params=tree(s["params"]), alive=jnp.asarray(s["alive"]),
                  adam=JAdam(mu=tree(s["mu"]), nu=tree(s["nu"]),
                             count=jnp.int32(s["count"])),
                  stats=j_stats_init(s["alive"].shape[0]),
                  iteration=jnp.int32(s["iteration"]))


def _port_state(s):
    n = s["alive"].shape[0]
    z = np.zeros(n, np.float32)
    return convert.train_state_from_numpy(
        s["params"], s["alive"], s["mu"], s["nu"], s["count"],
        dict(grad_accum=z, denom=z, max_radii=z), s["iteration"],
        device="cpu")


def _assert_same(t_state, j_state, adam=True):
    np.testing.assert_array_equal(t_state.alive.numpy(),
                                  np.asarray(j_state.alive))
    trees = [("params", t_state.params, j_state.params)]
    if adam:
        trees += [("mu", t_state.adam.mu, j_state.adam.mu),
                  ("nu", t_state.adam.nu, j_state.adam.nu)]
    for name, t, j in trees:
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(t, k).numpy(),
                                          np.asarray(getattr(j, k)),
                                          err_msg=f"{name} {k}")
    assert int(t_state.iteration) == int(j_state.iteration)
    assert int(t_state.adam.count) == int(j_state.adam.count)
    assert t_state.iteration.dtype == torch.int32
    for x in t_state.stats:
        assert float(x.abs().sum()) == 0.0


def test_both_packages_write_the_same_file(tmp_path):
    s = _numpy_state(0)
    pj = JC.save_checkpoint(str(tmp_path / "j"), _jax_state(s))
    pt = TC.save_checkpoint(str(tmp_path / "t"), _port_state(s))
    assert os.path.basename(pj) == os.path.basename(pt) == \
        "chkpnt_ws=1_rk=0.npz"
    dj, dt = np.load(pj), np.load(pt)
    assert sorted(dj.files) == sorted(dt.files)
    for k in dj.files:
        assert dj[k].dtype == dt[k].dtype, k
        np.testing.assert_array_equal(dj[k], dt[k], err_msg=k)
    assert dt["param_means3d"].shape[0] == 150      # alive only


def test_port_reads_a_jax_checkpoint_ws1(tmp_path):
    s = _numpy_state(1)
    d = str(tmp_path)
    JC.save_checkpoint(d, _jax_state(s))
    for cap in (None, 512):
        _assert_same(TC.load_checkpoint(d, capacity=cap, device="cpu"),
                     JC.load_checkpoint(d, capacity=cap))
        _assert_same(TC.load_checkpoint_sharded(d, 1, capacity=cap,
                                                device="cpu"),
                     JC.load_checkpoint_sharded(d, 1, capacity=cap))


def test_port_reads_a_jax_checkpoint_ws2(tmp_path):
    d = str(tmp_path)
    shards = [_numpy_state(2 + r, n_alive=100 + 30 * r) for r in range(2)]
    for r, s in enumerate(shards):
        JC.save_checkpoint(d, _jax_state(s), rank=r, world_size=2)
    # one device reads the two-rank set: merged, Adam dropped
    t1 = TC.load_checkpoint_sharded(d, 1, device="cpu")
    _assert_same(t1, JC.load_checkpoint_sharded(d, 1))
    assert int(t1.alive.sum()) == 230
    assert all(float(m.abs().sum()) == 0 for m in t1.adam.mu)
    assert int(t1.adam.count) == 0
    # the same world size keeps each rank's Adam moments
    _assert_same(TC.load_checkpoint_sharded(d, 2, device="cpu"),
                 JC.load_checkpoint_sharded(d, 2))
    for r in range(2):
        _assert_same(TC.load_checkpoint(d, rank=r, world_size=2,
                                        device="cpu"),
                     JC.load_checkpoint(d, rank=r, world_size=2))
    # an elastic split to three ranks, and duplication for scaling runs
    for r in range(3):
        _assert_same(TC.load_checkpoint(d, rank=r, world_size=3,
                                        device="cpu"),
                     JC.load_checkpoint(d, rank=r, world_size=3), adam=False)
    _assert_same(TC.load_checkpoint_sharded(d, 1, duplicate_coeff=1.5,
                                            device="cpu"),
                 JC.load_checkpoint_sharded(d, 1, duplicate_coeff=1.5))


def test_jax_reads_a_port_checkpoint(tmp_path):
    d = str(tmp_path)
    s = _numpy_state(5)
    ts = _port_state(s)
    TC.save_checkpoint(d, ts, rank=1, world_size=2)
    TC.save_checkpoint(d, _port_state(_numpy_state(6, n_alive=90)), rank=0,
                       world_size=2)
    for ws in (1, 2):
        _assert_same(TC.load_checkpoint_sharded(d, ws, device="cpu"),
                     JC.load_checkpoint_sharded(d, ws))
    # rank 1 round-trips its live slots exactly, packed to the front
    back = JC.load_checkpoint(d, rank=1, world_size=2)
    idx = np.nonzero(s["alive"])[0]
    for k in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(back.params, k))[:150], s["params"][k][idx])
        np.testing.assert_array_equal(
            np.asarray(getattr(back.adam.nu, k))[:150], s["nu"][k][idx])
    assert int(back.iteration) == 40 and int(back.adam.count) == 20


def test_checkpoint_set_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        TC.load_checkpoint(str(tmp_path), device="cpu")
    s = _port_state(_numpy_state(7))
    TC.save_checkpoint(str(tmp_path), s, rank=0, world_size=2)
    with pytest.raises(ValueError, match="expected 2 shard files"):
        TC.load_checkpoint_sharded(str(tmp_path), 2, device="cpu")
    TC.save_checkpoint(str(tmp_path), s, rank=1, world_size=2)
    with pytest.raises(ValueError, match="exceeds capacity"):
        TC.load_checkpoint_sharded(str(tmp_path), 2, capacity=8,
                                   device="cpu")


def test_find_latest_checkpoint(tmp_path):
    root = str(tmp_path)
    assert TC.find_latest_checkpoint(root) is None
    assert JC.find_latest_checkpoint(root) is None
    for it in ("7", "300", "40", "notes"):
        os.makedirs(os.path.join(root, "checkpoints", it))
    want = os.path.join(root, "checkpoints", "300")
    assert TC.find_latest_checkpoint(root) == JC.find_latest_checkpoint(
        root) == want


def test_tuner_state_from_a_jax_set(tmp_path):
    """The port's loop restores its capacity state from a tuner.json that
    the JAX loop wrote on two devices (keys it has no use for ignored,
    per-device quantities scaled by 2)."""
    scene = testing.SyntheticScene(n_cams=2, n_test=0, width=32, height=16,
                                   n_gaussians=40, n_init_points=30, seed=1,
                                   device="cpu")
    d = str(tmp_path / "ckpt")
    jax_tuner = {"n_devices": 2, "isect_cap_current": 20480,
                 "blend_cap_current": 16384, "kept_peak": 9000.0,
                 "isect_peak": 11000.0, "a2a_factor": 1.5,
                 "a2a_peak": 400.0, "densify_growth_ratio": 1.7,
                 "max_shard_alive": 700, "densify_count": 4}
    JC.save_tuner_state(d, jax_tuner)
    s = _numpy_state(8)
    TC.save_checkpoint(d, _port_state(s))
    cfg = TrainConfig()
    cfg.start_checkpoint = d
    cfg.model.model_path = str(tmp_path / "model")
    cfg.quiet = True
    cfg.model.sh_degree = 3
    cfg.dist.bsz = 2
    t = Trainer(cfg.finalize(), scene, device="cpu")
    assert int(t.state.iteration) == 40 and int(t.state.alive.sum()) == 150
    assert t.densify_count == 4
    assert t._densify_growth_ratio == 1.7
    assert t._max_alive == 1400
    assert t._isect_peak == 22000.0
    assert t._isect_cap() == t._round_cap(40960) == 40960
    # and the port's own tuner state, read back by the JAX loader
    t.save_checkpoint(52)
    saved = JC.load_tuner_state(os.path.join(cfg.model.model_path,
                                             "checkpoints", "52"))
    assert saved == json.loads(json.dumps(t._tuner_state()))
    assert saved["n_devices"] == 1 and saved["max_shard_alive"] == 1400
