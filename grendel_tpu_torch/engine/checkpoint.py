"""Training checkpoints (parameters, Adam state, iteration), elastic across
world sizes, in the JAX package's npz format.

Counterpart of grendel_tpu/engine/checkpoint.py, file for file: rank r of
world size w writes ``chkpnt_ws={w}_rk={r}.npz`` holding its alive
Gaussians only (capacity padding stripped) as ``param_<field>``,
``mu_<field>`` and ``nu_<field>`` for the six ``GaussianParams`` fields,
plus ``iteration`` and ``adam_count``. A set written by either package
loads in the other. Loading with the world size it was written with
restores Adam; any other world size re-splits the packed Gaussians by
contiguous chunks and drops Adam, as the JAX package does.
``tuner.json`` beside the shards carries the host-side capacity state of
the training loop.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.densify import densify_stats_init
from ..models.gaussian_model import GaussianParams, round_capacity
from ..models.optimizer import AdamState, adam_init
from .train import TrainState

_PARAM_FIELDS = list(GaussianParams._fields)
_FILLS = {"scales_raw": -10.0, "opacities_raw": -10.0}
TUNER_FILE = "tuner.json"


def checkpoint_name(ws: int, rank: int) -> str:
    return f"chkpnt_ws={ws}_rk={rank}.npz"


def save_checkpoint(directory: str, state: TrainState, rank: int = 0,
                    world_size: int = 1) -> str:
    """Write this shard's checkpoint (its alive Gaussians); returns the
    file path."""
    os.makedirs(directory, exist_ok=True)
    alive = state.alive.cpu().numpy()
    idx = np.nonzero(alive)[0]
    payload = {
        "iteration": np.asarray(int(state.iteration), np.int32),
        "adam_count": np.asarray(int(state.adam.count), np.int32),
    }
    for f in _PARAM_FIELDS:
        for prefix, tree in (("param", state.params), ("mu", state.adam.mu),
                             ("nu", state.adam.nu)):
            payload[f"{prefix}_{f}"] = getattr(tree, f).cpu().numpy()[idx]
    path = os.path.join(directory, checkpoint_name(world_size, rank))
    np.savez(path, **payload)
    return path


def _find_shards(directory: str) -> Tuple[int, List[str]]:
    rx = re.compile(r"chkpnt_ws=(\d+)_rk=(\d+)\.npz$")
    found = []
    for fn in os.listdir(directory):
        m = rx.match(fn)
        if m:
            found.append((int(m.group(1)), int(m.group(2)), fn))
    if not found:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    ws = found[0][0]
    if any(w != ws for w, _, _ in found):
        raise ValueError(f"mixed world sizes in {directory}")
    if len(found) != ws:
        raise ValueError(f"expected {ws} shard files in {directory}, found "
                         f"{len(found)}")
    found.sort(key=lambda t: t[1])
    return ws, [os.path.join(directory, fn) for _, _, fn in found]


def _state_from_numpy(params: dict, alive: np.ndarray, adam, iteration: int,
                      dev) -> TrainState:
    """TrainState on ``dev`` from padded numpy leaves; ``adam`` is
    (mu dict, nu dict, count) or None for fresh moments. Dead slots get
    the identity rotation."""
    params["quats"][~alive, 0] = 1.0

    def tree(d):
        return GaussianParams(**{f: torch.as_tensor(d[f], device=dev)
                                 for f in _PARAM_FIELDS})

    p = tree(params)
    if adam is None:
        adam_state = adam_init(p)
    else:
        mu, nu, count = adam
        adam_state = AdamState(mu=tree(mu), nu=tree(nu), count=torch.tensor(
            int(count), dtype=torch.int32, device=dev))
    return TrainState(
        params=p, alive=torch.as_tensor(alive, device=dev), adam=adam_state,
        stats=densify_stats_init(alive.shape[0], dev),
        iteration=torch.tensor(int(iteration), dtype=torch.int32,
                               device=dev))


def load_checkpoint(directory: str, rank: int = 0, world_size: int = 1,
                    capacity: Optional[int] = None,
                    duplicate_coeff: float = 1.0,
                    device=DEFAULT_DEVICE) -> TrainState:
    """Load (and re-split if need be) rank ``rank``'s share of a checkpoint
    set for ``world_size`` ranks, padded to ``capacity`` (default: the
    share rounded up to 256).

    ``duplicate_coeff`` > 1 repeats the packed Gaussians, with a 1e-4
    position jitter on the copies from ``np.random.default_rng(0)``, to
    make larger models for scaling experiments; it drops Adam."""
    dev = resolve_device(device)
    saved_ws, paths = _find_shards(directory)
    same_ws = saved_ws == world_size and duplicate_coeff == 1.0
    datas = [np.load(paths[rank])] if same_ws else [np.load(p) for p in paths]

    def packed(prefix: str, f: str) -> np.ndarray:
        out = np.concatenate([d[f"{prefix}_{f}"] for d in datas], axis=0)
        if duplicate_coeff > 1.0:
            n = out.shape[0]
            total = int(n * duplicate_coeff)
            out = np.concatenate([out] * -(-total // n), axis=0)[:total]
            if prefix == "param" and f == "means3d":
                rng = np.random.default_rng(0)
                out[n:] += rng.normal(scale=1e-4,
                                      size=out[n:].shape).astype(out.dtype)
        return out

    total = packed("param", "means3d").shape[0]
    lo, hi = ((0, total) if same_ws else
              (rank * total // world_size, (rank + 1) * total // world_size))
    m = hi - lo
    cap = capacity if capacity is not None else round_capacity(max(m, 1))
    if m > cap:
        raise ValueError(f"shard size {m} exceeds capacity {cap}")

    def pad(x: np.ndarray, fill: float = 0.0) -> np.ndarray:
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:m] = x[lo:hi]
        return out

    params = {f: pad(packed("param", f), _FILLS.get(f, 0.0))
              for f in _PARAM_FIELDS}
    adam = None
    if same_ws:
        adam = ({f: pad(packed("mu", f)) for f in _PARAM_FIELDS},
                {f: pad(packed("nu", f)) for f in _PARAM_FIELDS},
                datas[0]["adam_count"])
    return _state_from_numpy(params, np.arange(cap) < m, adam,
                             int(datas[0]["iteration"]), dev)


def load_checkpoint_sharded(directory: str, world_size: int = 1,
                            capacity: Optional[int] = None,
                            duplicate_coeff: float = 1.0,
                            device=DEFAULT_DEVICE) -> TrainState:
    """Load a checkpoint set for ``world_size`` ranks as ONE TrainState
    whose capacity axis is block-partitioned (rank d's share at rows
    [d * cap, (d + 1) * cap)). With the saved world size the per-rank Adam
    moments are kept; any other world size (for instance a set of two
    ranks read with ``world_size`` 1) goes through the per-rank re-split
    of :func:`load_checkpoint` and drops Adam."""
    dev = resolve_device(device)
    saved_ws, paths = _find_shards(directory)
    if saved_ws != world_size or duplicate_coeff != 1.0:
        total = sum(int(np.load(p)["param_means3d"].shape[0]) for p in paths)
        total = int(total * max(duplicate_coeff, 1.0))
        cap = (capacity if capacity is not None
               else round_capacity(max(-(-total // world_size), 1)))
        shards = [load_checkpoint(directory, rank=d, world_size=world_size,
                                  capacity=cap,
                                  duplicate_coeff=duplicate_coeff,
                                  device="cpu")
                  for d in range(world_size)]
        params = {f: np.concatenate([getattr(s.params, f).numpy()
                                     for s in shards])
                  for f in _PARAM_FIELDS}
        alive = np.concatenate([s.alive.numpy() for s in shards])
        return _state_from_numpy(params, alive, None,
                                 int(shards[0].iteration), dev)

    datas = [np.load(p) for p in paths]
    sizes = [int(d["param_means3d"].shape[0]) for d in datas]
    cap = (capacity if capacity is not None
           else round_capacity(max(max(sizes), 1)))
    if max(sizes) > cap:
        raise ValueError(f"shard size {max(sizes)} exceeds capacity {cap}")

    def assemble(prefix: str, f: str, fill: float = 0.0) -> np.ndarray:
        sample = datas[0][f"{prefix}_{f}"]
        out = np.full((world_size * cap,) + sample.shape[1:], fill,
                      np.float32)
        for d, (data, m) in enumerate(zip(datas, sizes)):
            out[d * cap: d * cap + m] = data[f"{prefix}_{f}"]
        return out

    alive = np.zeros(world_size * cap, bool)
    for d, m in enumerate(sizes):
        alive[d * cap: d * cap + m] = True
    params = {f: assemble("param", f, _FILLS.get(f, 0.0))
              for f in _PARAM_FIELDS}
    adam = ({f: assemble("mu", f) for f in _PARAM_FIELDS},
            {f: assemble("nu", f) for f in _PARAM_FIELDS},
            datas[0]["adam_count"])
    return _state_from_numpy(params, alive, adam,
                             int(datas[0]["iteration"]), dev)


def save_tuner_state(directory: str, tuner: dict) -> str:
    """Write ``tuner.json`` beside the shard files: the training loop's
    host-side capacity state (entry capacity and its observed peak, the
    densify growth ratio and alive count, the densify count), so a resume
    does not learn them again."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, TUNER_FILE)
    with open(path, "w") as f:
        json.dump(tuner, f, indent=1)
    return path


def load_tuner_state(directory: str) -> Optional[dict]:
    """``tuner.json`` if the set has one."""
    path = os.path.join(directory, TUNER_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def find_latest_checkpoint(checkpoints_root: str) -> Optional[str]:
    """The latest iteration subdirectory under ``<root>/checkpoints``."""
    base = os.path.join(checkpoints_root, "checkpoints")
    if not os.path.isdir(base):
        return None
    iters = [d for d in os.listdir(base) if d.isdigit()]
    if not iters:
        return None
    return os.path.join(base, max(iters, key=int))
