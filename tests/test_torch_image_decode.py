"""Images without PIL: the port's JPEG decoder, PNG unfiltering and
bilinear resize against PIL and the JAX package, bit for bit.

  * native/jpeg_decode.c (utils/jpeg.py ``read_jpeg``) against
    ``np.asarray(Image.open(path))`` on files PIL writes here from a numpy
    seed: 4:4:4, 4:2:2 and 4:2:0 chroma at quality 75 and 95, grey,
    progressive, restart markers, optimized tables, sizes that are not a
    multiple of the MCU; and on the committed fixtures of tests/data/jpeg
    against PIL's decodes committed beside them;
  * the files the decoder refuses raise, naming the file: arithmetic
    coding, 12-bit and lossless frames, CMYK, truncated data;
  * ops/resize.py ``resize_bilinear_plain`` (the resize kernel's plain
    version, which the CPU takes) against ``Image.resize(size,
    Image.BILINEAR)`` for RGB, L and RGBA, down and up, at integer and
    other ratios;
  * data/scene.py ``decode_image`` against the JAX package's on the same
    ``CameraInfo``: JPEG and PNG, RGB and RGBA over a background, with and
    without ``size``; the truck views of tests/data/jpeg/truck against the
    sha256 of the JAX package's decodes committed there;
  * data/readers.py ``_image_size`` against PIL's size;
  * utils/png.py ``read_png`` (native/png_unfilter.c) against PIL and the
    plain ``_unfilter`` on PNGs whose rows carry each of filters 0-4.
"""

import hashlib
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from grendel_tpu.data import readers as JR
from grendel_tpu.data import scene as JS
from grendel_tpu_torch.data import readers as TR
from grendel_tpu_torch.data import scene as TS
from grendel_tpu_torch.ops.resize import resize_bilinear_plain
from grendel_tpu_torch.utils import png as P
from grendel_tpu_torch.utils.jpeg import read_jpeg

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"


def _image(w, h, seed, channels=3):
    """A smooth gradient with noise: PIL's encoder and filters see both
    flat and busy blocks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([3 * xx + 5 * yy, 200 - 2 * xx + yy, (xx * yy) % 97 + 60,
                     255 - (xx * 7) % 256], axis=-1)[..., :channels]
    return np.clip(base + rng.integers(0, 32, base.shape), 0,
                   255).astype(np.uint8)


def _info(path, bg=None, w=0, h=0):
    return JR.CameraInfo(uid=0, R=np.eye(3), T=np.zeros(3), fovx=1.0,
                         fovy=1.0, image_path=str(path), image_name="im",
                         width=w, height=h, bg=bg)


JPEG_KINDS = {
    "444_q75": dict(quality=75, subsampling=0),
    "422_q75": dict(quality=75, subsampling=1),
    "420_q75": dict(quality=75, subsampling=2),
    "420_q95": dict(quality=95, subsampling=2),
    "444_q95": dict(quality=95, subsampling=0),
    "grey": dict(quality=80),
    "progressive_420": dict(quality=85, subsampling=2, progressive=True),
    "progressive_444": dict(quality=90, subsampling=0, progressive=True),
    "progressive_grey": dict(quality=70, progressive=True),
    "restart_blocks": dict(quality=85, subsampling=2,
                           restart_marker_blocks=3),
    "restart_rows": dict(quality=60, subsampling=1, restart_marker_rows=1),
    "optimized": dict(quality=50, subsampling=2, optimize=True),
}


@pytest.mark.parametrize("kind", sorted(JPEG_KINDS))
def test_jpeg_decoder_matches_pil(tmp_path, kind):
    opts = JPEG_KINDS[kind]
    grey = kind.endswith("grey")
    for i, (w, h) in enumerate([(1, 1), (3, 2), (17, 9), (130, 67)]):
        img = _image(w, h, seed=100 * i + len(kind))
        path = tmp_path / f"{kind}_{w}x{h}.jpg"
        Image.fromarray(img[..., 0] if grey else img).save(path, **opts)
        with Image.open(path) as im:
            want = np.asarray(im)
        got = read_jpeg(str(path))
        assert got.shape == want.shape, (w, h)
        np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h}")


@pytest.mark.parametrize("name", sorted(p.stem for p in
                                        FIXTURES.glob("*.jpg")))
def test_committed_fixtures_decode_to_pils(name):
    want = P.read_png(str(FIXTURES / f"{name}.png"))
    got = read_jpeg(str(FIXTURES / f"{name}.jpg"))
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def _patched(src: bytes, offset_of, value: int) -> bytes:
    data = bytearray(src)
    data[offset_of(data)] = value
    return bytes(data)


def _sof(data):
    return data.index(b"\xff\xc0")


@pytest.mark.parametrize("case", ["arithmetic", "12-bit", "lossless",
                                  "cmyk", "truncated"])
def test_refused_jpegs_raise_naming_the_file(tmp_path, case):
    buf = tmp_path / "base.jpg"
    Image.fromarray(_image(24, 16, seed=5)).save(buf, quality=80)
    src = buf.read_bytes()
    path = tmp_path / f"refused_{case}.jpg"
    if case == "arithmetic":
        data = _patched(src, lambda d: _sof(d) + 1, 0xC9)
    elif case == "12-bit":
        data = _patched(src, lambda d: _sof(d) + 4, 12)
    elif case == "lossless":
        data = _patched(src, lambda d: _sof(d) + 1, 0xC3)
    elif case == "cmyk":
        Image.fromarray(_image(24, 16, seed=5, channels=4), "CMYK").save(path)
        data = path.read_bytes()
    else:
        data = src[:len(src) * 2 // 3]
    path.write_bytes(data)
    match = {"arithmetic": "arithmetic", "12-bit": "12-bit",
             "lossless": "lossless", "cmyk": "CMYK",
             "truncated": "truncated"}[case]
    with pytest.raises(ValueError, match=f"refused_{case}.jpg.*{match}"):
        read_jpeg(str(path))


RESIZE_CASES = {
    "down_2x": ((64, 48), (32, 24)),
    "down_odd": ((97, 61), (40, 33)),
    "down_truck_ratio": ((196, 109), (160, 89)),
    "up_2x": ((23, 17), (46, 34)),
    "up_odd": ((19, 13), (50, 29)),
    "one_axis": ((40, 30), (40, 11)),
}


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_resize_plain_matches_pil(case, mode):
    (w, h), size = RESIZE_CASES[case]
    chans = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
    img = _image(w, h, seed=3, channels=chans)
    if mode == "RGBA":
        # every kind of alpha: transparent, opaque and in between
        img[..., 3] = np.random.default_rng(4).choice(
            [0, 255, 1, 77, 128, 254], (h, w))
    pil = Image.fromarray(img[..., 0] if chans == 1 else img, mode)
    want = np.asarray(pil.resize(size, Image.BILINEAR))
    got = resize_bilinear_plain(torch.from_numpy(img.reshape(h, w, chans)),
                                size).numpy()
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("fmt,mode", [("jpg", "RGB"), ("jpg", "L"),
                                      ("png", "RGB"), ("png", "RGBA"),
                                      ("png", "L")])
@pytest.mark.parametrize("size", [None, (30, 21), (71, 50)])
def test_decode_image_matches_jax(tmp_path, fmt, mode, size):
    chans = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    img = _image(53, 37, seed=11, channels=chans)
    if mode == "RGBA":
        img[::3, :, 3] = 0
        img[1::3, :, 3] = 255
    path = tmp_path / f"im_{mode}.{fmt}"
    Image.fromarray(img[..., 0] if chans == 1 else img, mode).save(path)
    info = _info(path, bg=np.array([1.0, 0.5, 0.0]))
    want = JS.decode_image(info, size=size)
    got = TS.decode_image(TR.CameraInfo(*info), size=size, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_truck_views_match_jax_decodes():
    """Each committed truck view (1957x1091, PIL's JPEG) decoded by the
    port and resized to 1600x891 gives the bytes whose sha256 the JAX
    package's decode gave; one view against a live JAX decode too."""
    meta = json.loads((FIXTURES / "truck" / "sha256.json").read_text())
    size = tuple(meta["size"])
    assert TS.resolve_resolution(1957, 1091, -1) == size == (1600, 891)
    for name, digest in sorted(meta["sha256"].items()):
        info = _info(FIXTURES / "truck" / name, w=1957, h=1091)
        got = TS.decode_image(TR.CameraInfo(*info), size, device="cpu")
        assert got.shape == (3, 891, 1600)
        assert hashlib.sha256(got.tobytes()).hexdigest() == digest, name
    np.testing.assert_array_equal(got, JS.decode_image(info, size))
    assert len(meta["sha256"]) == 10


@pytest.mark.parametrize("kind", ["baseline", "progressive", "grey", "png"])
def test_image_size_matches_pil(tmp_path, kind):
    img = _image(45, 31, seed=2)
    path = tmp_path / ("im.png" if kind == "png" else "im.jpg")
    pil = Image.fromarray(img[..., 0] if kind == "grey" else img)
    pil.save(path, **({"progressive": True} if kind == "progressive"
                      else {}))
    with Image.open(path) as im:
        want = im.size
    assert TR._image_size(str(path)) == JR._image_size(str(path)) == want


def _png_with_filters(path, img, filters):
    """Write ``img`` (H, W, C) as a PNG whose row y carries filter
    ``filters[y % len(filters)]`` (the PNG specification's predictors)."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        kind = filters[y % len(filters)]
        prev = x[y - 1] if y else np.zeros(w * c, np.int32)
        left = np.concatenate([np.zeros(c, np.int32), x[y, :-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if kind == 0:
            pred = np.zeros_like(x[y])
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([kind]) + ((x[y] - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                           0)))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(rows))))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 2, 1, 0)])
def test_read_png_unfilters_like_pil(tmp_path, filters, channels):
    img = _image(23, 11, seed=channels, channels=4)[..., :channels]
    path = tmp_path / "f.png"
    _png_with_filters(path, img, filters)
    got = P.read_png(str(path))
    with Image.open(path) as im:
        want = np.asarray(im).reshape(got.shape)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img.reshape(got.shape))
    # the plain version, a row at a time
    rows = img.reshape(img.shape[0], -1).astype(np.int32)
    prev = np.zeros(rows.shape[1], np.int32)
    data = path.read_bytes()
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    inflated = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        rows.shape[0], -1).astype(np.int32)
    for y in range(rows.shape[0]):
        prev = P._unfilter(int(inflated[y, 0]), inflated[y, 1:], prev,
                           channels)
        np.testing.assert_array_equal(prev, rows[y])
