"""The multi-device path: row division, the sparse all-to-all, the
distributed step (counterpart of grendel_tpu/parallel/)."""

from .division import (  # noqa: F401
    DivisionHistory,
    divide_rows,
    divide_rows_whole_images,
    pack_gt_rows,
    rows_of_device,
)
from ..engine.train import normalize_grads_by_visibility  # noqa: F401
from .sharded import DistributedTrainer, ParallelConfig  # noqa: F401
