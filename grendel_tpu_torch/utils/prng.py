"""The JAX package's random numbers, drawn with PyTorch.

``jax.random``'s default generator is threefry2x32, a counter-based hash:
a draw is a function of its key and of each element's flat index, so it
is the same on every device. This module computes it, with JAX's key
derivation and its layout of counters (``jax_threefry_partitionable``,
on by default since JAX 0.5), and the draws the training loop takes:

  * :func:`key`: ``jax.random.key(seed)`` for 0 <= seed < 2^63;
  * :func:`fold_in`: ``jax.random.fold_in(key, data)``, of an int or of
    an int tensor (a step's iteration, folded on its device);
  * :func:`uniform`: ``jax.random.uniform(key, shape, minval=lo,
    maxval=hi)`` in float32, bit for bit; :func:`uniform_host` the same
    few floats on the host, in Python ints and numpy;
  * :func:`normal`: ``jax.random.normal(key, shape)`` in float32: the same
    uniform draw, bit for bit, through XLA's single-precision erfinv
    polynomial (:func:`erfinv`), whose log1p and rounding differ from
    XLA's CPU code in about one value of twenty, by at most 3 ulp;
  * :func:`randint`: ``jax.random.randint(key, shape, 0, high)`` in int32,
    exactly.

The port draws the densify's split offsets, the redistribution's
destinations and the random background here, from the JAX package's
keys, so that a run draws the numbers the JAX package's run draws on the
same seed, on the CPU and on the card alike. A key is a pair of ints
below 2^32; arrays are computed in int64 under 32-bit masks, in chunks
of :data:`CHUNK` elements.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
# the rotations of threefry2x32's two alternating groups of four rounds
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
CHUNK = 1 << 22

Key = Tuple[int, int]


def threefry2x32(k: Key, x0, x1):
    """The threefry2x32 hash of the counter pairs (x0, x1) under key
    ``k``: ints, or int64 tensors holding values below 2^32."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)``: the seed's high and low 32 bits."""
    seed = int(seed)
    if not 0 <= seed < 1 << 63:
        raise ValueError(f"seed {seed} outside [0, 2^63)")
    return (seed >> 32) & MASK, seed & MASK


def fold_in(k: Key, data) -> Key:
    """``jax.random.fold_in(k, data)`` for 0 <= data < 2^32 (JAX's
    ``split(k)[i]`` is ``fold_in(k, i)`` too). ``data`` may be an int
    tensor of one value: the key is then a pair of int64 tensors on its
    device, computed there without reading ``data`` back, and the draws
    below take it as they take a key of ints."""
    if isinstance(data, torch.Tensor):
        return threefry2x32(k, 0, data.to(torch.int64) & MASK)
    return threefry2x32(k, 0, int(data) & MASK)


def random_bits(k: Key, n: int, device) -> torch.Tensor:
    """(n,) int64: JAX's 32 random bits of each flat index under ``k``."""
    out = torch.empty(n, dtype=torch.int64, device=device)
    for lo in range(0, n, CHUNK):
        idx = torch.arange(lo, min(lo + CHUNK, n), dtype=torch.int64,
                           device=device)
        b0, b1 = threefry2x32(k, idx >> 32, idx & MASK)
        out[lo:lo + idx.shape[0]] = b0 ^ b1
    return out


def uniform(k: Key, shape: Sequence[int], lo: float, hi: float,
            device) -> torch.Tensor:
    """``jax.random.uniform(k, shape, minval=lo, maxval=hi)``: 23 random
    mantissa bits of a float in [1, 2), less 1, times the float32 span,
    plus ``lo`` in one rounding (XLA fuses the two into a multiply-add:
    here in float64, where the product is exact), clamped below by
    ``lo``; float32."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    bits = random_bits(k, math.prod(shape), device)
    unit = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    u = ((unit - 1.0).double() * float(hi32 - lo32) + float(lo32)).float()
    return torch.clamp(u, min=float(lo32)).reshape(tuple(shape))


def uniform_host(k: Key, n: int, lo: float, hi: float) -> np.ndarray:
    """(n,) float32: :func:`uniform` ``(k, (n,), lo, hi)`` bit for bit,
    computed on the host in Python ints and numpy, for a few elements
    (the work of some hundred int operations a value, where
    :func:`uniform` runs as many tensor ops)."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    bits = np.array([b0 ^ b1 for b0, b1 in (
        threefry2x32(k, i >> 32, i & MASK) for i in range(n))], np.uint32)
    unit = ((bits >> 9) | 0x3F800000).astype(np.uint32).view(np.float32)
    u = ((unit - np.float32(1)).astype(np.float64) * float(hi32 - lo32)
         + float(lo32)).astype(np.float32)
    return np.maximum(u, lo32)


def normal(k: Key, shape: Sequence[int], device) -> torch.Tensor:
    """``jax.random.normal(k, shape)``: float32 standard normals, JAX's
    uniform on [nextafter(-1, 0), 1) through erfinv, times sqrt(2)."""
    low = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = uniform(k, shape, low, 1.0, device)
    return erfinv(u) * float(np.float32(math.sqrt(2)))


# XLA's ErfInv32 (M. Giles, "Approximating the erfinv function"): Horner
# coefficients for w = -log1p(-x^2) below 5 (in w - 2.5) and above it (in
# sqrt(w) - 3)
ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv, term for term (+-inf at +-1)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.zeros_like(x)
    for a, b in zip(ERFINV_W_LT_5, ERFINV_W_GE_5):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1, x * math.inf, p * x)


def randint(k: Key, shape: Sequence[int], high: int,
            device) -> torch.Tensor:
    """``jax.random.randint(k, shape, 0, high)``: int32 in [0, high),
    from two draws of bits reduced as JAX reduces them."""
    n, span = math.prod(shape), max(int(high), 1)
    higher = random_bits(fold_in(k, 0), n, device)
    lower = random_bits(fold_in(k, 1), n, device)
    multiplier = (((1 << 16) % span) ** 2 & MASK) % span
    offset = ((higher % span) * multiplier) & MASK
    offset = ((offset + lower % span) & MASK) % span
    return offset.to(torch.int32).reshape(tuple(shape))
