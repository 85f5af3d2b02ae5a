"""Port parity of the random redistribution: grendel_tpu_torch's pack,
exchange and place, for D=4 ranks simulated in one process (the exchange
is the index recv[r] = buckets[:, r], the all-to-all's effect), against
grendel_tpu's ``build_redistribute`` on a 4-device mesh.

The port draws its destinations with ``torch.randint``; here it is given
JAX's: ``jax.random.randint(fold_in(key(it), d), (n_loc,), 0, D)``, with
dead slots and self-destinations mapped to D. Parameters, both Adam
moments, the alive mask and the (D, 3) info table must then be bit-equal:
the round only moves rows. Two cases: a skewed model (every live Gaussian
in the first ranks' slots, some buckets full), and a full one where the
ranks receive more rows than they have free slots, so rows are dropped
(the counterpart of tests/test_redistribute.py's high-occupancy case).
Both conserve the alive count: alive after + dropped = alive before.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from grendel_tpu.models.gaussian_model import GaussianParams as JParams
from grendel_tpu.models.optimizer import AdamState as JAdam
from grendel_tpu.parallel.redistribute import build_redistribute
from grendel_tpu_torch.models.gaussian_model import GaussianParams
from grendel_tpu_torch.models.optimizer import AdamState
from grendel_tpu_torch.parallel import redistribute as R

D, CAP = 4, 512
N_LOC = CAP // D
SHAPES = dict(means3d=(3,), sh_dc=(1, 3), sh_rest=(3, 3), scales_raw=(3,),
              quats=(4,), opacities_raw=())


def _tree(rng):
    return {k: rng.standard_normal((CAP,) + s).astype(np.float32)
            for k, s in SHAPES.items()}


def _jax_round(mesh, params, mu, nu, alive, it, send_cap):
    fn = build_redistribute(mesh, D, send_cap=send_cap)
    shard = NamedSharding(mesh, P("d"))

    def put(tree):
        return JParams(**{k: jax.device_put(jnp.asarray(v), shard)
                          for k, v in tree.items()})

    adam = JAdam(mu=put(mu), nu=put(nu), count=jnp.asarray(3, jnp.int32))
    p2, a2, adam2, info = fn(put(params), jax.device_put(alive, shard), adam,
                             jax.random.key(it))
    return jax.device_get((p2, a2, adam2.mu, adam2.nu, info))


def _jax_destinations(alive, it):
    out = []
    for d in range(D):
        draw = np.asarray(jax.random.randint(
            jax.random.fold_in(jax.random.key(it), d), (N_LOC,), 0, D))
        dest = np.where(alive[d * N_LOC:(d + 1) * N_LOC], draw, D)
        out.append(np.where(dest == d, D, dest).astype(np.int32))
    return out


def _port_round(params, mu, nu, alive, dests, send_cap):
    """pack on every rank, the all-to-all as an index, place on every
    rank. Returns the whole state's (params, alive, mu, nu) and info."""
    def rank_tree(tree, d):
        return GaussianParams(**{k: torch.from_numpy(
            v[d * N_LOC:(d + 1) * N_LOC]) for k, v in tree.items()})

    rows, packed = [], []
    for d in range(D):
        adam = AdamState(mu=rank_tree(mu, d), nu=rank_tree(nu, d),
                         count=torch.tensor(3, dtype=torch.int32))
        r = R.flatten(rank_tree(params, d), adam)
        rows.append((r, adam, rank_tree(params, d)))
        packed.append(R.pack(r, torch.from_numpy(dests[d]), D, send_cap))
    buckets = torch.stack([p[0] for p in packed])     # (D src, D dst, cap, F)
    out = {k: [] for k in ("params", "alive", "mu", "nu")}
    info = []
    for d in range(D):
        r, adam, p = rows[d]
        _, sent, n_sent, overflow = packed[d]
        recv = buckets[:, d].reshape(-1, r.shape[1])
        new_rows, alive_d, dropped = R.place(
            r, torch.from_numpy(alive[d * N_LOC:(d + 1) * N_LOC]), sent, recv)
        p2, adam2 = R.unflatten(new_rows, p, adam)
        out["params"].append(p2)
        out["mu"].append(adam2.mu)
        out["nu"].append(adam2.nu)
        out["alive"].append(alive_d)
        info.append([int(n_sent), int(overflow), int(dropped)])

    def whole(trees):
        return {k: torch.cat([getattr(t, k) for t in trees]).numpy()
                for k in SHAPES}

    return (whole(out["params"]), torch.cat(out["alive"]).numpy(),
            whole(out["mu"]), whole(out["nu"]), np.array(info, np.int32))


@pytest.mark.parametrize("case", ["skewed", "full"])
def test_round_is_bit_equal_to_jax(case, eight_devices):
    rng = np.random.default_rng(7)
    params, mu, nu = _tree(rng), _tree(rng), _tree(rng)
    if case == "skewed":         # ranks 0-1 full, rank 2 a third, 3 empty
        alive = np.arange(CAP) < 300
        it, send_cap = 42, 24
    else:                        # every slot but a few alive
        alive = rng.random(CAP) < 0.98
        it, send_cap = 5, 64
    mesh = Mesh(np.array(eight_devices[:D]), ("d",))
    jp, ja, jmu, jnu, jinfo = _jax_round(mesh, params, mu, nu, alive, it,
                                         send_cap)
    tp, ta, tmu, tnu, tinfo = _port_round(
        params, mu, nu, alive, _jax_destinations(alive, it), send_cap)

    np.testing.assert_array_equal(tinfo, np.asarray(jinfo))
    np.testing.assert_array_equal(ta, np.asarray(ja))
    for k in SHAPES:
        np.testing.assert_array_equal(tp[k], np.asarray(getattr(jp, k)), k)
        np.testing.assert_array_equal(tmu[k], np.asarray(getattr(jmu, k)), k)
        np.testing.assert_array_equal(tnu[k], np.asarray(getattr(jnu, k)), k)
    # the alive count is conserved, up to the rows reported dropped
    assert ta.sum() + tinfo[:, 2].sum() == alive.sum()
    assert tinfo[:, 0].sum() > 0
    if case == "skewed":
        assert tinfo[:, 1].sum() > 0 and tinfo[:, 2].sum() == 0, tinfo
        per_rank = ta.reshape(D, N_LOC).sum(axis=1)
        assert per_rank.min() > 0, per_rank
    else:
        assert tinfo[:, 2].sum() > 0, tinfo


def test_destinations_stay_for_dead_and_own_rank():
    alive = torch.arange(4096) % 3 > 0
    dest = R.destinations(alive, 1, D, seed=9)
    assert dest.dtype == torch.int32
    assert bool((dest[~alive] == D).all())
    assert not bool((dest == 1).any())
    moving = dest[alive & (dest < D)]
    counts = torch.bincount(moving, minlength=D)[:D]
    assert counts[1] == 0 and counts[[0, 2, 3]].min() > 0
    # the same seed draws the same destinations
    assert torch.equal(dest, R.destinations(alive, 1, D, seed=9))
