"""Inclusive int32 prefix scan over C equal-length channels (kernel K3).

Counterpart of grendel_tpu/ops/scan_pallas.py (``_cumsum_kernel:65``,
``cumsum_i32_multi:79``, ``cumsum_i32:118``). The tile-list build
(ops/isect.py) scans its per-Gaussian entry counts and the scatter-delta
buffers of its segment broadcasts with it.

On a CUDA tensor :func:`cumsum_i32_multi` launches the hand-written kernel
in ``csrc/scan.cu``, a single-pass scan with decoupled look-back; on a CPU
tensor it takes the plain version, :func:`cumsum_i32_multi_plain`. Results
are bit-equal to ``torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)``:
int32 adds wrap and are associative.

The kernel's blocks publish their tile sums in status words tagged with an
epoch, and take their tiles from a ticket counter that is never reset.
:class:`ScanScratch` keeps both per device and stream and does the
bookkeeping, so that no call clears or allocates anything in the common
case.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels

MAX_CHANNELS = 8      # csrc/scan.cu kMaxChannels
EPOCH_MAX = (1 << 30) - 1   # csrc/scan.cu kEpochMask


class ScanScratch:
    """The scan's scratch on one device and stream: one int64 tensor whose
    word 0 is the ticket counter and whose other words are the status
    words, with the epoch and the count of tickets issued so far.

    ``alloc(n)`` returns a zeroed int64 tensor of n words. Call
    :meth:`reserve` before a launch of ``n_blocks`` blocks and
    :meth:`issued` after it has been enqueued."""

    def __init__(self, alloc):
        self.alloc = alloc
        self.words = None
        self.epoch = 0
        self.tickets = 0

    def reserve(self, n_blocks: int):
        """(words, ticket_base, epoch) for the next launch: the array grows
        (zeroed, counter at 0) when it holds fewer than ``n_blocks`` status
        words, and its status words are zeroed when the epoch wraps."""
        if self.words is None or self.words.numel() - 1 < n_blocks:
            size = 256
            while size < n_blocks:
                size *= 2
            self.words = self.alloc(1 + size)
            self.epoch = self.tickets = 0
        if self.epoch >= EPOCH_MAX:
            self.words[1:].zero_()
            self.epoch = 0
        self.epoch += 1
        return self.words, self.tickets, self.epoch

    def issued(self, n_blocks: int) -> None:
        self.tickets = (self.tickets + n_blocks) % (1 << 32)


@functools.lru_cache(maxsize=None)
def tile_elems() -> int:
    """Elements per block of the kernel (csrc/scan.cu kTile), from its
    library."""
    return kernels.load("scan").gts_scan_tile_elems()


# (device index, stream handle) -> ScanScratch
_scratch: dict = {}


def _raw_stream(index: int) -> int:
    """The handle of device ``index``'s current stream (what
    ``torch.cuda.current_stream(index).cuda_stream`` gives, without making
    a Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _scratch_of(index: int, stream: int) -> ScanScratch:
    scratch = _scratch.get((index, stream))
    if scratch is None:
        dev = torch.device("cuda", index)
        scratch = _scratch[(index, stream)] = ScanScratch(
            lambda n: torch.zeros(n, dtype=torch.int64, device=dev))
    return scratch


def scan_scratch(dev: torch.device) -> ScanScratch:
    """The scratch of ``dev``'s current stream, made at first use."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _scratch_of(index, _raw_stream(index))


def cumsum_i32_multi_plain(xs) -> list:
    """Plain version: one ``torch.cumsum`` per channel."""
    return [torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32) for x in xs]


def cumsum_i32_multi(xs) -> list:
    """Inclusive cumsum of each 1-D array in ``xs`` (same length, same
    device), as int32.

    The scans are short (about 0.01 ms on the card), so the host's time to
    reach the launch is a cost of its own: the launch path makes no
    Stream object and enters no device context unless the channels lie on
    another device than the current one."""
    xs = [x.to(torch.int32).contiguous() for x in xs]
    if not xs or len(xs) > MAX_CHANNELS:
        raise ValueError(f"need 1..{MAX_CHANNELS} channels, got {len(xs)}")
    m = xs[0].shape[0]
    dev = xs[0].device
    for x in xs:
        if x.dim() != 1 or x.shape[0] != m or x.device != dev:
            raise ValueError("channels must be 1-D, equal length, one device")
    if dev.type == "cpu":
        return cumsum_i32_multi_plain(xs)
    if dev.type != "cuda":
        raise ValueError(f"no scan kernel for device {dev}")
    index = dev.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return cumsum_i32_multi(xs)
    lib = kernels.load("scan")
    outs = [torch.empty_like(x) for x in xs]
    n_blocks = len(xs) * -(-m // tile_elems())
    ins = (ctypes.c_void_p * len(xs))(*[x.data_ptr() for x in xs])
    outp = (ctypes.c_void_p * len(xs))(*[o.data_ptr() for o in outs])
    stream = _raw_stream(index)
    scratch = _scratch_of(index, stream)
    words, base, epoch = scratch.reserve(n_blocks)
    kernels.check(lib.gts_scan_i32(
        ins, outp, len(xs), m, words.data_ptr() + 8, words.data_ptr(), base,
        epoch, stream), "scan kernel")
    scratch.issued(n_blocks)
    cumsum_i32_multi.launches += 1
    return outs


cumsum_i32_multi.launches = 0


def cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """Single-channel form of :func:`cumsum_i32_multi`."""
    return cumsum_i32_multi([x])[0]
