"""PNG files without PIL: a writer and a reader for the tools and the
datasets.

The render tool writes its images with :func:`write_png`, and the metrics
tool and the dataset readers (data/readers.py, data/scene.py) read them
with :func:`read_png`, on machines that have zlib and numpy but not PIL.
The reader takes any 8-bit, non-interlaced grey, grey with alpha, RGB or
RGBA PNG, with every row filter, so it also reads what PIL or another
tool wrote; :func:`png_header` says whether it can. zlib inflates the
rows and native/png_unfilter.c undoes their filters; :func:`_unfilter`
is its plain version, a row at a time in numpy.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

from ..native import png_unfilter

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W) or (H, W, C) uint8 image, C in 1-4, with row filter
    0 (none)."""
    arr = np.ascontiguousarray(image, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    ctype = {v: k for k, v in _CHANNELS.items()}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * c)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(_chunk(b"IEND", b""))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(kind: int, line: np.ndarray, prev: np.ndarray,
              bpp: int) -> np.ndarray:
    """One row's bytes (int32) from its filtered bytes and the row above:
    the plain version of native/png_unfilter.c (the Average and Paeth
    filters a pixel at a time)."""
    if kind == 0:
        return line
    if kind == 2:
        return (line + prev) & 0xFF
    if kind == 1:
        # the left neighbour's sum: a running sum along each channel
        px = line.reshape(-1, bpp)
        return (np.cumsum(px, axis=0) & 0xFF).reshape(-1)
    out = line.copy()
    for x in range(0, line.shape[0], bpp):
        a = out[x - bpp:x] if x else np.zeros(bpp, np.int32)
        b = prev[x:x + bpp]
        if kind == 3:
            out[x:x + bpp] = (line[x:x + bpp] + (a + b) // 2) & 0xFF
        elif kind == 4:
            c = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
            out[x:x + bpp] = (line[x:x + bpp] + _paeth(a, b, c)) & 0xFF
        else:
            raise ValueError(f"PNG row filter {kind}")
    return out


class PngHeader(NamedTuple):
    width: int
    height: int
    depth: int
    colour_type: int
    interlace: int

    @property
    def readable(self) -> bool:
        """True when :func:`read_png` reads the file."""
        return (self.depth == 8 and self.colour_type in _CHANNELS
                and not self.interlace)


def png_header(path: str) -> Optional[PngHeader]:
    """The IHDR fields of a PNG file, or None when the file is not a PNG."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR" or len(head) < 29:
        return None
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        head[16:29])
    return PngHeader(w, h, depth, ctype, interlace)


def read_png(path: str) -> np.ndarray:
    """(H, W, C) uint8 of an 8-bit, non-interlaced PNG (C = 1-4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit, non-interlaced grey, RGB and "
                         f"alpha PNGs are read (depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (1 + w * c):
        raise ValueError(f"{path}: truncated PNG data")
    try:
        out = png_unfilter(raw[:h * (1 + w * c)].reshape(h, 1 + w * c), c)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return out.reshape(h, w, c)
