"""The distributed step's collectives over the default torch.distributed
process group.

The JAX package's step calls ``lax`` collectives inside ``shard_map``;
this is their counterpart for one process per device:

  * :func:`init_group`: NCCL for a ``cuda`` device, gloo for the CPU
    (:func:`destroy_group` leaves it); for the ranks of one machine,
    :func:`spawn_local` starts them, :func:`free_port` finds their
    rendezvous and :func:`join_local` joins each to the group;
  * :func:`all_to_all`: the sparse exchange, differentiable (its backward
    is the same exchange of the gradient);
  * :func:`all_reduce_sum`, :func:`all_reduce_max` and
    :func:`all_reduce_min`: one collective over a list of tensors, packed
    into one flat buffer;
  * :func:`all_gather`: every rank's tensor, stacked (the telemetry).

Every rank must call these in the same order: gloo and NCCL match
collectives by the order in which they are called.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from ..utils.timer import span


def init_group(device, rank: Optional[int] = None,
               world_size: Optional[int] = None, store=None) -> None:
    """Join the default process group: NCCL for a ``cuda`` device, gloo
    for the CPU. Without ``store`` the rank, world size and rendezvous come
    from the ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
    environment variables. A ``cuda`` device without an index is the card
    ``LOCAL_RANK`` names (torchrun sets it; 0 without it), so that the
    ranks of one machine take one card each."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        index = (int(os.environ.get("LOCAL_RANK", 0)) if dev.index is None
                 else dev.index)
        torch.cuda.set_device(torch.device("cuda", index))
    if store is not None:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size)
    else:
        dist.init_process_group(backend, init_method="env://")


def destroy_group() -> None:
    """Leave the default process group."""
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port of 127.0.0.1, for the ranks' rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join_local(rank: int, world: int, port: int, device) -> torch.device:
    """Join, as ``rank``, a group of ``world`` ranks of this machine that
    meet at 127.0.0.1:``port``: NCCL with rank r on ``cuda:r`` for a
    ``cuda`` device, gloo on one thread for the CPU. Returns the rank's
    device."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    if torch.device(device).type == "cuda":
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    init_group(dev)
    return dev


def spawn_local(fn: Callable, args: tuple, nprocs: int, timeout: float,
                what: str) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes and join
    them. A rank's exception raises here with its traceback; a run past
    ``timeout`` seconds (a hung collective) raises ``TimeoutError`` naming
    ``what``; no process outlives the call."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.time() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
            if time.time() > deadline:
                raise TimeoutError(f"{what} ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join()


def _exchange(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous())
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _exchange(x)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g)


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Block ``x[s]`` of this rank goes to rank ``s``; block ``out[s]`` came
    from rank ``s``. ``x`` has the world size as its leading axis (equal
    splits). Differentiable in ``x``."""
    with span("exchange"):
        if torch.is_grad_enabled() and x.requires_grad:
            return _AllToAll.apply(x)
        return _exchange(x)


def _all_reduce(tensors: List[torch.Tensor], op) -> List[torch.Tensor]:
    # float64 carries int64 values (entry counts) exactly up to 2^53
    wide = any(t.dtype in (torch.int64, torch.float64) for t in tensors)
    dtype = torch.float64 if wide else torch.float32
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat, op=op)
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].reshape(t.shape).to(t.dtype))
        at += n
    return out


def all_reduce_sum(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over ranks of each tensor, through one collective on one
    flat float32 buffer (float64 when a tensor is int64 or float64); each
    result keeps its tensor's shape and dtype."""
    return _all_reduce(tensors, dist.ReduceOp.SUM)


def all_reduce_max(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The largest value over ranks of each tensor, the same way."""
    return _all_reduce(tensors, dist.ReduceOp.MAX)


def all_reduce_min(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The smallest value over ranks of each tensor, the same way."""
    return _all_reduce(tensors, dist.ReduceOp.MIN)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """(world_size,) + x.shape: every rank's ``x``, in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.stack(parts)
