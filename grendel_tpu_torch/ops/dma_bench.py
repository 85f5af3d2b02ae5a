"""The DMA microbenchmark's kernels: contiguous chunk loads (kernel K4) and
scattered row gathers (kernel K5), each folded into per-chunk checksums.

Counterpart of scripts/microbench_dma.py's ``contig_kernel:98`` and
``scattered_kernel:126``. The TPU kernels write placeholders; these fold
what they load into one int32 per chunk, the wrap-around sum of the
float32 bit patterns, which the plain versions reproduce bit for bit.

  * :func:`contig_checksum` (K4): one checksum per (16, 128) f32 chunk of
    ``src`` (n_chunks, 16, 128).
  * :func:`scattered_checksum` (K5): per chunk of 128 ``ids``, gather the
    rows ``table[ids]`` (width 16 or 128), run ``vpu_iters`` rounds of
    ``x = x * 1.000001 + 0.5`` on them in float32, and fold. An id outside
    [0, len(table)) gathers a row of zeros.

On a CUDA tensor each launches ``csrc/dma_bench.cu``; on a CPU tensor it
takes its plain version. Neither falls back.
"""

from __future__ import annotations

import torch

from .. import kernels

CHUNK_SHAPE = (16, 128)      # K4's chunk: the blend payload's layout
IDS_PER_CHUNK = 128          # K5's rows per chunk
ROW_WIDTHS = (16, 128)       # K5's row widths (f32): 64 bytes, 512 bytes
VPU_MUL, VPU_ADD = 1.000001, 0.5


def _wrap_sum(bits: torch.Tensor) -> torch.Tensor:
    """Row sums of an int32 (n, k) tensor modulo 2^32, as int32."""
    s = bits.to(torch.int64).sum(dim=1)
    return (((s + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


def contig_checksum_plain(src: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: (n_chunks,) int32."""
    return _wrap_sum(src.contiguous().view(torch.int32).reshape(
        src.shape[0], -1))


def scattered_checksum_plain(table: torch.Tensor, ids: torch.Tensor,
                             vpu_iters: int = 0) -> torch.Tensor:
    """Plain version of K5: (len(ids) // 128,) int32."""
    n = table.shape[0]
    ids = ids.to(torch.int64)
    valid = (ids >= 0) & (ids < n)
    rows = torch.where(valid[:, None], table[ids.clamp(0, max(n - 1, 0))],
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))
    mul = torch.tensor(VPU_MUL, dtype=torch.float32, device=table.device)
    add = torch.tensor(VPU_ADD, dtype=torch.float32, device=table.device)
    for _ in range(vpu_iters):
        rows = rows * mul + add
    return _wrap_sum(rows.contiguous().view(torch.int32).reshape(
        ids.shape[0] // IDS_PER_CHUNK, -1))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte aligned address (the kernels load
    16 bytes at a time)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def contig_checksum(src: torch.Tensor) -> torch.Tensor:
    """Checksum of every (16, 128) f32 chunk of ``src`` (n_chunks, 16,
    128): (n_chunks,) int32."""
    if src.dtype != torch.float32 or src.dim() != 3 or \
            tuple(src.shape[1:]) != CHUNK_SHAPE:
        raise ValueError(f"src must be (n_chunks, 16, 128) float32, got "
                         f"{tuple(src.shape)} {src.dtype}")
    if src.device.type == "cpu":
        return contig_checksum_plain(src)
    if src.device.type != "cuda":
        raise ValueError(f"no dma_bench kernel for device {src.device}")
    src = _aligned(src)
    out = torch.empty(src.shape[0], dtype=torch.int32, device=src.device)
    lib = kernels.load("dma_bench")
    with torch.cuda.device(src.device):
        kernels.check(lib.gts_dma_contig(src.data_ptr(), src.shape[0],
                                         out.data_ptr(), _stream(src.device)),
                      "dma contig kernel")
    contig_checksum.launches += 1
    return out


def scattered_checksum(table: torch.Tensor, ids: torch.Tensor,
                       vpu_iters: int = 0) -> torch.Tensor:
    """Per chunk of 128 ``ids`` ((n_chunks * 128,) int32), the checksum of
    the gathered rows of ``table`` ((n, W) float32, W in ROW_WIDTHS) after
    ``vpu_iters`` rounds: (n_chunks,) int32."""
    if table.dtype != torch.float32 or table.dim() != 2 or \
            table.shape[1] not in ROW_WIDTHS:
        raise ValueError(f"table must be (n, W) float32 with W in "
                         f"{ROW_WIDTHS}, got {tuple(table.shape)} "
                         f"{table.dtype}")
    if ids.dim() != 1 or ids.shape[0] % IDS_PER_CHUNK or \
            ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32 of a length divisible by "
                         f"{IDS_PER_CHUNK}, got {tuple(ids.shape)} "
                         f"{ids.dtype}")
    if vpu_iters < 0:
        raise ValueError(f"vpu_iters must be >= 0, got {vpu_iters}")
    if ids.device != table.device:
        raise ValueError("table and ids must be on one device")
    if table.device.type == "cpu":
        return scattered_checksum_plain(table, ids, vpu_iters)
    if table.device.type != "cuda":
        raise ValueError(f"no dma_bench kernel for device {table.device}")
    table, ids = _aligned(table), ids.contiguous()
    n_chunks = ids.shape[0] // IDS_PER_CHUNK
    out = torch.empty(n_chunks, dtype=torch.int32, device=table.device)
    lib = kernels.load("dma_bench")
    with torch.cuda.device(table.device):
        kernels.check(lib.gts_dma_scattered(
            table.data_ptr(), table.shape[0], table.shape[1], ids.data_ptr(),
            n_chunks, vpu_iters, out.data_ptr(), _stream(table.device)),
            "dma scattered kernel")
    scattered_checksum.launches += 1
    return out


contig_checksum.launches = 0
scattered_checksum.launches = 0
