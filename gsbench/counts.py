"""The yardstick's arithmetic: published peaks, and the operations and
bytes that a step or a frame needs, counted from the cell's shapes and
the reference's pair counts, whatever implements them.

Peaks are NVIDIA's data sheet for one H100 SXM at 700 W: 3.35 TB/s of
HBM3 and 67 TFLOP/s of float32 outside the tensor cores. The per-pair
rules are those the program's own kernel table uses (``chip_smoke.py``):
a walked (entry, pixel) pair costs one exp and about 15 float32
operations, and the backward adds about 44 for each pair the forward
blended.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
K1_OPS_PER_PAIR = 16
K2_OPS_PER_BLENDED = 44

# SSIM and L1 per pixel and channel: five 11-tap blurs of two passes in
# the forward (a multiply and an add a tap), the three that depend on the
# rendered image again in the backward, and about 40 operations of
# products, the SSIM formula and L1 around them
LOSS_OPS_PER_SAMPLE = (5 + 3) * 2 * 11 * 2 + 40
# projection (view transform, EWA covariance, conic, radius) and SH of
# one live Gaussian for one camera, per SH basis function 3 multiply-adds
PROJ_OPS = 150
SH_OPS_PER_BASIS = 6
# the backward of projection and SH costs about twice the forward
BACKWARD_FACTOR = 2
# Adam on one float of a live Gaussian: moments, bias correction, sqrt,
# division and the update
ADAM_OPS_PER_FLOAT = 12


def floats_per_gaussian(sh_degree_max: int) -> int:
    return 3 + 3 * (sh_degree_max + 1) ** 2 + 3 + 4 + 1


def blend_fwd_cost(walked: int, entries: int, pixels: int, n_splats: int):
    """(operations, bytes) of the forward blend: each walked pair's
    operations; each splat's 9 floats and each entry's id read once, each
    pixel's colour and transmittance written once."""
    return (K1_OPS_PER_PAIR * walked,
            n_splats * 9 * 4 + entries * 4 + pixels * 4 * 4)


def blend_bwd_cost(walked: int, blended: int, entries: int, pixels: int,
                   n_splats: int):
    """(operations, bytes) of the blend's backward: the walk again and the
    gradient of each blended pair; each splat read and its 9 gradients
    written, each entry's id read and its row of 9 sums written and read
    back once, each pixel's colour, transmittance and their cotangents read
    once."""
    return (K1_OPS_PER_PAIR * walked + K2_OPS_PER_BLENDED * blended,
            n_splats * 9 * 4 * 2 + entries * (4 + 9 * 4 * 2)
            + pixels * 8 * 4)


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def train_step_ops(walked: int, blended: int, pixels: int, cams: int,
                   live: int, sh_degree: int, sh_degree_max: int) -> float:
    """Operations a training step needs: blend forward and backward, the
    loss of every pixel and channel, projection and SH of every live
    Gaussian for each camera with their backward, and Adam on every float
    of every live Gaussian."""
    proj = PROJ_OPS + SH_OPS_PER_BASIS * (sh_degree + 1) ** 2
    return (2 * K1_OPS_PER_PAIR * walked + K2_OPS_PER_BLENDED * blended
            + LOSS_OPS_PER_SAMPLE * 3 * pixels
            + (1 + BACKWARD_FACTOR) * proj * live * cams
            + ADAM_OPS_PER_FLOAT * floats_per_gaussian(sh_degree_max) * live)


def render_ops(walked: int, live: int, sh_degree: int) -> float:
    """Operations a frame needs: the forward blend and projection and SH
    of every live Gaussian."""
    proj = PROJ_OPS + SH_OPS_PER_BASIS * (sh_degree + 1) ** 2
    return K1_OPS_PER_PAIR * walked + proj * live
