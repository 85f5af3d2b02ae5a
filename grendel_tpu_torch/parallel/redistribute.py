"""Random redistribution of Gaussians between ranks.

Counterpart of grendel_tpu/parallel/redistribute.py (the reference's
``redistribute_gaussians``): every few densifications each alive Gaussian
of a rank draws a uniformly random destination rank, and its parameters
and both Adam moments move there in one all-to-all, which keeps the
shards balanced in expectation.

The send buckets have a fixed capacity, as in the JAX package: a
Gaussian whose bucket is full stays where it is. Received rows take the
rank's free slots; rows beyond the free slots are dropped and counted
(``recv_dropped``), and the loop then keeps its old state, grows the
capacity and skips the round.

The pieces are plain functions of one rank's tensors: :func:`pack` builds
the buckets, :func:`exchange` moves them, :func:`place` writes what
arrived; :func:`redistribute` runs them on the default process group.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..models.gaussian_model import GaussianParams
from ..models.optimizer import AdamState
from ..utils import prng
from . import comm

I32 = torch.int32


def destinations(alive: torch.Tensor, rank: int, world: int,
                 seed: int) -> torch.Tensor:
    """(n,) int32 destination rank of each slot: uniform over the ranks,
    the JAX package's draw ``jax.random.randint(fold_in(key(seed), rank),
    (n,), 0, world)`` (utils/prng.py); ``world`` (stay) for a dead slot
    and for a slot that drew its own rank."""
    dest = prng.randint(prng.fold_in(prng.key(seed), rank), alive.shape,
                        world, alive.device)
    stay = ~alive | (dest == rank)
    return torch.where(stay, torch.full_like(dest, world), dest)


def flatten(params: GaussianParams, adam: AdamState) -> torch.Tensor:
    """(n, F) rows [params | mu | nu | 1], each leaf row-major."""
    n = params.means3d.shape[0]
    leaves = list(params) + list(adam.mu) + list(adam.nu)
    return torch.cat([x.reshape(n, -1) for x in leaves]
                     + [torch.ones((n, 1), device=params.means3d.device)],
                     dim=1)


def unflatten(rows: torch.Tensor, params: GaussianParams,
              adam: AdamState) -> Tuple[GaussianParams, AdamState]:
    """The inverse of :func:`flatten`, shaped like ``params``."""
    out, at = [], 0
    for x in list(params) * 3:
        size = x[0].numel()
        out.append(rows[:, at:at + size].reshape(x.shape))
        at += size
    k = len(params)
    return (GaussianParams(*out[:k]),
            adam._replace(mu=GaussianParams(*out[k:2 * k]),
                          nu=GaussianParams(*out[2 * k:])))


def pack(rows: torch.Tensor, dest: torch.Tensor, world: int, send_cap: int):
    """The send buckets of one rank: rows sorted stably by destination,
    the first ``send_cap`` of each destination into its bucket. Returns
    (buckets (world, send_cap, F), sent (n,) bool: the rows that leave,
    n_sent (), send_overflow (): the rows that stay for want of room)."""
    n, f = rows.shape
    dev = rows.device
    sorted_dest, perm = torch.sort(dest, stable=True)
    starts = torch.searchsorted(
        sorted_dest, torch.arange(world + 1, device=dev, dtype=I32),
        out_int32=True)
    in_dest = (torch.arange(n, device=dev, dtype=I32)
               - starts[sorted_dest.clamp(0, world - 1).long()])
    in_cap = (sorted_dest < world) & (in_dest < send_cap)
    slot = torch.where(in_cap, sorted_dest * send_cap + in_dest,
                       torch.full_like(in_dest, world * send_cap)).long()
    overflow = torch.clamp(starts[1:] - starts[:-1] - send_cap, min=0).sum()
    buckets = rows.new_zeros((world * send_cap + 1, f))
    buckets[slot] = rows[perm]           # the spare last row takes the rest
    sent = torch.zeros(n, dtype=torch.bool, device=dev)
    sent[perm] = in_cap
    return (buckets[:-1].reshape(world, send_cap, f), sent, in_cap.sum(),
            overflow)


@torch.no_grad()
def exchange(buckets: torch.Tensor) -> torch.Tensor:
    """Bucket r goes to rank r; returns the buckets received, (world *
    send_cap, F)."""
    return comm.all_to_all(buckets).reshape(-1, buckets.shape[-1])


def place(rows: torch.Tensor, alive: torch.Tensor, sent: torch.Tensor,
          recv: torch.Tensor):
    """Write the received rows (flag column > 0) into the free slots: the
    slots not alive or sent away, in stable order, dead ones first.
    Returns (rows, alive, recv_dropped ())."""
    n = alive.shape[0]
    stay = alive & ~sent
    valid = recv[:, -1] > 0
    free_order = torch.sort(stay.to(I32), stable=True).indices
    n_free = n - stay.sum()
    r_rank = torch.cumsum(valid.to(I32), 0) - 1
    ok = valid & (r_rank < n_free)
    dst = torch.where(ok, free_order[r_rank.clamp(0, n - 1).long()],
                      torch.full_like(r_rank, n, dtype=torch.int64))
    out = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
    out[dst] = recv                       # the spare last row takes the rest
    new_alive = torch.cat([stay, stay.new_zeros(1)])
    new_alive[dst] = True
    return out[:n], new_alive[:n], valid.sum() - ok.sum()


def redistribute(params: GaussianParams, alive: torch.Tensor,
                 adam: AdamState, iteration: int, send_cap: int):
    """One round on this rank of the default process group, with the
    destinations of JAX's key ``iteration`` folded with the rank. Returns
    (params, alive, adam, info (D, 3) int32 [n_sent, send_overflow,
    recv_dropped] of every rank, the same on every rank)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    rows = flatten(params, adam)
    buckets, sent, n_sent, overflow = pack(
        rows, destinations(alive, rank, world, iteration), world, send_cap)
    rows, alive, dropped = place(rows, alive, sent, exchange(buckets))
    params, adam = unflatten(rows, params, adam)
    info = comm.all_gather(torch.stack([n_sent, overflow, dropped]).to(I32))
    return params, alive, adam, info
