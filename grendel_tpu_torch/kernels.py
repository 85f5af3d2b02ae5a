"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface and loaded with
``ctypes``. The build happens at first use, from the sources in the
checkout only, into ``_build/`` (listed in ``.gitignore``); the library
name carries a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is reused. :func:`build` compiles several
sources at once, one ``nvcc`` process each. :func:`cold_ms` is the
timing that chip_smoke.py and scripts/time_kernels.py report.

Nothing here runs at import time: the CPU tests import every module of
the package on machines that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import statistics
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("scan", "rasterize_fwd", "rasterize_bwd", "segment_sum",
           "dma_bench", "resize", "projection")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # no fused multiply-adds: the plain PyTorch versions round every
    # product and sum on its own, and the kernels are held to them
    "--fmad=false",
    "-Xptxas", "-v",
)

_c_int, _c_i64, _ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
_c_f32 = ctypes.c_float
# C signatures: function -> (restype, argtypes)
SIGNATURES = {
    "scan": {
        "gts_scan_tile_elems": (_c_int, []),
        "gts_scan_i32": (_c_int, [
            ctypes.POINTER(_ptr), ctypes.POINTER(_ptr),  # ins outs
            _c_int, _c_i64,                  # n_channels m
            _ptr, _ptr,                      # status counter
            ctypes.c_uint32, ctypes.c_uint32,  # ticket_base epoch
            _ptr,                            # stream
        ]),
    },
    "rasterize_fwd": {
        "gts_rasterize_fwd": (_c_int, [
            _ptr, _ptr, _ptr, _ptr,          # means2d conics colors opacities
            _ptr, _c_i64, ctypes.c_int32,    # gauss_ids n_entries n_gauss
            _ptr, _ptr, _ptr, _ptr,          # tile_lo tile_hi px0 py0
            _c_int, _c_int, _c_int, _c_int,  # n_slots tile_w tile_h mpt
            _ptr, _ptr, _ptr,                # out_colors out_t stream
        ]),
    },
    "rasterize_bwd": {
        "gts_rasterize_bwd": (_c_int, [
            _ptr, _ptr, _ptr, _ptr,          # means2d conics colors opacities
            _ptr, _c_i64, ctypes.c_int32,    # gauss_ids n_entries n_gauss
            _ptr, _ptr, _ptr, _ptr,          # tile_lo tile_hi px0 py0
            _c_int, _c_int, _c_int, _c_int,  # n_slots tile_w tile_h mpt
            _ptr, _ptr, _ptr, _ptr,          # c_total final_t g_colors g_t
            _ptr, _ptr,                      # d_rows stream
        ]),
    },
    "segment_sum": {
        "gts_segment_sum_rows": (_c_int, [
            _ptr, _ptr, _ptr,                # rows sorted_ids perm
            _c_i64, ctypes.c_int32,          # n_entries n_seg
            _ptr, _ptr,                      # out stream
        ]),
    },
    "dma_bench": {
        "gts_dma_contig": (_c_int, [_ptr, _c_i64, _ptr, _ptr]),
        "gts_dma_scattered": (_c_int, [
            _ptr, _c_i64, _c_int,            # table n_rows width
            _ptr, _c_i64, _c_int,            # ids n_chunks vpu_iters
            _ptr, _ptr,                      # out stream
        ]),
    },
    "resize": {
        "gts_resize_bilinear": (_c_int, [
            _ptr, _ptr,                      # in out
            _c_int, _c_int, _c_int, _c_int,  # in_h in_w out_h out_w
            _c_int,                          # channels
            _ptr, _ptr, _c_int,              # xbounds xk xksize
            _ptr, _ptr, _c_int,              # ybounds yk yksize
            _c_int, _c_int, _c_int, _c_int,  # log_tile_w tile_h rows row_bytes
            _c_int,                          # taps
            _ptr,                            # stream
        ]),
    },
    "projection": {
        "gts_project_fwd": (_c_int, [
            _ptr, _ptr, _ptr, _ptr,          # means3d scales_raw quats opac_raw
            _ptr, _ptr, _ptr,                # sh_dc sh_rest alive
            _ptr, _ptr, _ptr, _ptr,          # viewmat full_proj campos tanfov
            _c_i64, _c_int, _c_int,          # n n_cams k_rest
            _c_int, _c_int, _c_int, _c_f32,  # img_h img_w sh_degree scale_mod
            _ptr, _ptr, _ptr,                # means2d conics colors
            _ptr, _ptr, _ptr,                # opacities depths radii
            _ptr,                            # stream
        ]),
        "gts_project_bwd": (_c_int, [
            _ptr, _ptr, _ptr, _ptr,          # means3d scales_raw quats opac_raw
            _ptr, _ptr,                      # sh_dc sh_rest
            _ptr, _ptr, _ptr, _ptr,          # viewmat full_proj campos tanfov
            _ptr,                            # radii
            _ptr, _ptr, _ptr, _ptr,          # g_means2d g_conics g_colors g_opac
            _c_i64, _c_int, _c_int,          # n n_cams k_rest
            _c_int, _c_int, _c_int, _c_f32,  # img_h img_w sh_degree scale_mod
            _ptr, _ptr, _ptr,                # d_means3d d_scales_raw d_quats
            _ptr, _ptr, _ptr,                # d_opac_raw d_sh_dc d_sh_rest
            _ptr,                            # stream
        ]),
    },
}

# name -> loaded library; a process-wide cache of dlopen handles
_loaded: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    # the headers of csrc/ (shared by the sources that include them) count
    # as part of every source
    src = b"".join(path.read_bytes() for path in [CSRC / f"{name}.cu"]
                   + sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library of ``names`` that is not built yet, all
    ``nvcc`` processes at once. Returns {name: compiler output} for the
    libraries it built; raises with the compiler output on a failure."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)     # atomic: a concurrent loader sees all
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# a spin of about half a millisecond on the card before a timed launch
SPIN_CYCLES = 1_000_000


def cold_ms(fn, reps: int, flush, spin: bool = False) -> float:
    """Median ms of one call of ``fn`` over ``reps`` calls, from CUDA
    events around each call, each after zeroing ``flush`` (a CUDA buffer
    larger than the 50 MB L2, so every call finds its inputs in device
    memory). The events also count any time the card waits for the host
    to reach the launch. With ``spin`` the card first spins for longer
    than the host takes to enqueue the call, so that the events read the
    device's time alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)
