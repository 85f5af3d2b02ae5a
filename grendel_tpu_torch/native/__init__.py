"""The port's host C library: ground-truth row packing, PNG unfiltering
and JPEG decoding.

Every ``native/*.c`` is compiled by the system C compiler (``cc``, else
``gcc``) with ``-O3 -shared -fPIC -pthread`` into one shared library,
loaded with ``ctypes``. The build runs at first use, from the sources in
the checkout, into ``grendel_tpu_torch/_build/`` (listed in
``.gitignore``); the library's name carries a hash of its sources and
flags, as ``kernels.library_path`` does, so an edited source is rebuilt.
The compiler writes a temporary file in that directory, which
``os.replace`` moves into place, so processes that build at once each
load a whole library. A failure to build or load raises with the
compiler's output: nothing falls back to numpy.

``ctypes`` releases the interpreter lock for the length of each call, so
threads (``data/scene.py Scene``'s decode threads) decode in parallel.

  * :func:`pack_gt_rows`: ``gtpack.c``, parallel/division.py
    ``pack_gt_rows``'s contract in threaded C (the JAX package's
    ``grendel_tpu/native/gtpack.c``);
  * :func:`png_unfilter`: ``png_unfilter.c``, PNG filters 0-4 over a
    whole image (utils/png.py ``read_png``);
  * :func:`decode_jpeg`: ``jpeg_decode.c``, a JPEG decoder bit-equal to
    PIL's (libjpeg-turbo's default decode; utils/jpeg.py ``read_jpeg``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

NATIVE = Path(__file__).resolve().parent
BUILD_DIR = NATIVE.parent / "_build"
CC_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_i32, _i64, _ptr = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
# C signatures: source -> {function: (restype, argtypes)}
SIGNATURES = {
    "gtpack": {
        "gtn_pack_gt_rows": (ctypes.c_int, [
            ctypes.POINTER(_ptr), _ptr, _ptr,   # images out division
            _i32, _i32, _i32,                   # n_devices max_rows tile_h
            _i32, _i32, _i32,                   # img_h img_w n_threads
        ]),
    },
    "png_unfilter": {
        "gtn_png_unfilter": (ctypes.c_int, [
            _ptr, _ptr, _i32, _i64, _i32,       # raw out height row_bytes bpp
        ]),
    },
    "jpeg_decode": {
        "gtn_jpeg_decode": (ctypes.c_int, [
            _ptr, _i64, _ptr, _i64,             # data size out out_size
            _ptr, _i32,                         # err err_len
        ]),
    },
}

# the pack's default threads: one for each PACK_BYTES_PER_THREAD of its
# buffer, at most PACK_MAX_THREADS (chip_smoke.py's pack_probe times the
# counts inside the multi-rank loop: a 6.4 MB pack was as often slower as
# faster on more threads, a 34 MB one 38-53% faster on 4 than on 1)
PACK_BYTES_PER_THREAD = 8 << 20
PACK_MAX_THREADS = 4

_lib = None
_lock = threading.Lock()


def sources():
    return sorted(NATIVE.glob("*.c"))


def compiler() -> str:
    for name in ("cc", "gcc"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C compiler: the port's host library "
                       "(grendel_tpu_torch/native/*.c) is built with cc or "
                       "gcc, and neither is on PATH")


def library_path() -> Path:
    src = b"".join(path.name.encode() + path.read_bytes()
                   for path in sources())
    digest = hashlib.sha256(src + " ".join(CC_FLAGS).encode())
    return BUILD_DIR / f"libgtnative-{digest.hexdigest()[:16]}.so"


def build() -> Optional[str]:
    """Compile the library unless it is built. Returns the compiler's
    output when it built it; raises with that output on a failure."""
    out = library_path()
    if out.exists():
        return None
    cc = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=out.stem + ".",
                               suffix=".tmp")
    os.close(fd)
    cmd = [cc, *CC_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the port's host library failed "
                           f"({' '.join(cmd)}):\n{proc.stdout}")
    os.replace(tmp, out)         # atomic: a concurrent loader sees all
    return proc.stdout


def load() -> ctypes.CDLL:
    """The library, built first if needed, its functions typed from
    :data:`SIGNATURES`."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            for table in SIGNATURES.values():
                for fn, (restype, argtypes) in table.items():
                    f = getattr(lib, fn)
                    f.restype = restype
                    f.argtypes = argtypes
            _lib = lib
    return _lib


def pack_gt_rows(cams, division_pos: np.ndarray, n_devices: int,
                 max_rows: int, tile_h: int, img_h: int, img_w: int,
                 gt_override=None, out: Optional[np.ndarray] = None,
                 n_threads: Optional[int] = None) -> np.ndarray:
    """parallel/division.py ``pack_gt_rows`` in C, on ``n_threads``
    threads: the same arguments and the same bytes. The copy is bound by
    the host's memory, and the process's own threads share the host's
    cores, so by default a thread packs at least
    ``PACK_BYTES_PER_THREAD`` of ``out``, on at most
    ``PACK_MAX_THREADS`` threads. An image that is not
    C-contiguous is copied whole first. Each camera with rows
    in the spans gives its image through ``Camera.gt()`` (a lazily stored
    camera decodes here, in Python) once; a camera whose image is None
    packs as zeros."""
    tiles_y = -(-img_h // tile_h)
    pos = np.ascontiguousarray(division_pos, np.int32)
    if pos.shape != (n_devices + 1,) or pos[0] < 0 or (np.diff(pos) < 0).any():
        raise ValueError(f"division_pos must be {n_devices + 1} ascending "
                         f"tile rows from 0 up, got {pos.tolist()}")
    if out is None:
        out = np.empty((n_devices, max_rows, 3, tile_h, img_w), np.uint8)
    if (out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"]
            or out.shape != (n_devices, max_rows, 3, tile_h, img_w)):
        raise ValueError(f"out must be C-contiguous uint8 "
                         f"{(n_devices, max_rows, 3, tile_h, img_w)}, got "
                         f"{out.dtype} {out.shape}")
    wanted = sorted({row // tiles_y for d in range(n_devices)
                     for row in range(int(pos[d]), min(int(pos[d + 1]),
                                                       int(pos[d])
                                                       + max_rows))})
    n_cams = len(gt_override) if gt_override is not None else len(cams)
    if wanted and wanted[-1] >= n_cams:
        raise ValueError(f"the division names image {wanted[-1]} of a "
                         f"batch of {n_cams}")
    images: Dict[int, np.ndarray] = {}
    ptrs = (_ptr * max(n_cams, 1))()
    for b in wanted:
        img = gt_override[b] if gt_override is not None else cams[b].gt()
        if img is None:
            continue
        img = np.ascontiguousarray(img, np.uint8)
        if img.shape != (3, img_h, img_w):
            raise ValueError(f"image {b} is {img.shape}, not "
                             f"{(3, img_h, img_w)}")
        images[b] = img                   # kept alive through the call
        ptrs[b] = img.ctypes.data
    if n_threads is None:
        n_threads = min(PACK_MAX_THREADS,
                        1 + out.nbytes // PACK_BYTES_PER_THREAD)
    load().gtn_pack_gt_rows(ptrs, out.ctypes.data, pos.ctypes.data,
                            n_devices, max_rows, tile_h, img_h, img_w,
                            n_threads)
    return out


def png_unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(H, row_bytes) uint8 of the inflated rows ``raw`` (H, 1 +
    row_bytes), each a filter-type byte then its filtered bytes. Raises
    ValueError naming the row of a filter type other than 0-4."""
    raw = np.ascontiguousarray(raw, np.uint8)
    h, row_bytes = raw.shape[0], raw.shape[1] - 1
    out = np.empty((h, row_bytes), np.uint8)
    bad = load().gtn_png_unfilter(raw.ctypes.data, out.ctypes.data, h,
                                  row_bytes, bpp)
    if bad:
        raise ValueError(f"PNG row filter {int(raw[bad - 1, 0])} in row "
                         f"{bad - 1}")
    return out


def decode_jpeg(data: bytes, shape: tuple, what: str) -> np.ndarray:
    """The decode of the JPEG file ``data`` into a new uint8 array of
    ``shape``, (H, W) for a grey file or (H, W, 3) for a colour one (the
    frame header's sizes: utils/jpeg.py ``jpeg_header``). Raises
    ValueError with the decoder's message and ``what`` (the file's name)
    where the file is not one the decoder takes."""
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(shape, np.uint8)
    err = ctypes.create_string_buffer(256)
    if load().gtn_jpeg_decode(buf.ctypes.data, buf.size, out.ctypes.data,
                              out.size, ctypes.addressof(err), len(err)):
        raise ValueError(f"{what}: {err.value.decode(errors='replace')}")
    return out
