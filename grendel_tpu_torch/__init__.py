"""grendel_tpu_torch — the PyTorch + CUDA port of grendel_tpu.

A second package beside ``grendel_tpu/`` (the JAX reference), with the
same module layout so each counterpart is easy to find. It imports
``torch`` and numpy, never ``jax`` or ``grendel_tpu``. Ported so
far: the render path (projection -> tile lists -> front-to-back blend)
and the single-GPU training step (``engine/train.py``: loss, backward,
hand-rolled Adam, densify statistics). Its three kernels are hand-written
CUDA C++ for Hopper under ``csrc/``:

  ops/scan_cuda.py       K3, inclusive int32 prefix scan (csrc/scan.cu)
  ops/rasterize_cuda.py  K1, forward tile blend (csrc/rasterize_fwd.cu)
                         K2, its backward (csrc/rasterize_bwd.cu)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a CPU tensor every kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.2.0"
