"""JPEG files without PIL: the frame header in Python, the decode in C.

The dataset readers (data/readers.py, data/scene.py) read a JPEG's size
from its frame header (:func:`jpeg_header`, the SOFn marker segment) and
decode it with :func:`read_jpeg`, through native/jpeg_decode.c, whose
output is bit-equal to PIL's ``np.asarray(Image.open(path))``: the
card's machine has no PIL. Baseline and progressive Huffman-coded 8-bit
files with one or three components are read; the decoder raises, naming
the file, on anything else.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional

import numpy as np

_SOI = b"\xff\xd8"
# start-of-frame markers: every SOFn but DHT (C4), JPG (C8) and DAC (CC)
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
        0xCE, 0xCF}


class JpegHeader(NamedTuple):
    width: int
    height: int
    components: int
    sof: int             # the frame's marker: 0xC0 baseline, 0xC2 progressive


def _frame_header(data: bytes) -> Optional[JpegHeader]:
    if data[:2] != _SOI:
        return None
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1                      # garbage between segments
            continue
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1                      # fill byte
            continue
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            pos += 2                      # no length
            continue
        if marker == 0xD9:
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if marker in _SOF and pos + 10 <= len(data):
            h, w, nc = struct.unpack(">HHB", data[pos + 5:pos + 10])
            return JpegHeader(w, h, nc, marker)
        pos += 2 + length
    raise ValueError("a JPEG file with no frame header (SOFn marker)")


def jpeg_header(path: str) -> Optional[JpegHeader]:
    """The frame header of a JPEG file, or None when the file is not a
    JPEG (no SOI marker)."""
    with open(path, "rb") as f:
        if f.read(2) != _SOI:
            return None
        data = _SOI + f.read()
    try:
        return _frame_header(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def read_jpeg(path: str) -> np.ndarray:
    """(H, W) uint8 of a grey JPEG, (H, W, 3) of a colour one: PIL's
    decode, bit for bit."""
    from .. import native

    with open(path, "rb") as f:
        data = f.read()
    try:
        hdr = _frame_header(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if hdr is None:
        raise ValueError(f"{path}: not a JPEG file")
    shape = ((hdr.height, hdr.width) if hdr.components == 1
             else (hdr.height, hdr.width, 3))
    return native.decode_jpeg(data, shape, path)
