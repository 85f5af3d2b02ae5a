"""Entry-capacity sizing and the device-memory budget of the tile lists.

The port's copies of what the trainer's capacity tuner takes from
grendel_tpu/utils/hbm.py: ``mantissa_round_cap``, the one rounding rule
the tuner and the benchmarks use to size the tile-list entry buffers, and
the budget model behind the entry ceiling (``Trainer._update_hbm_ceiling``):
the device's memory (:func:`device_bytes_limit`), the bytes a step takes
for each entry of capacity (``BYTES_PER_ISECT_ENTRY``) and the ceiling
they give (:func:`entry_ceiling`).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

# Device bytes a training step takes for each tile-list entry of its
# capacity, where the entries set the step's peak: 77.20, measured by
# chip_smoke.py phase 13 as the growth of a 4K step's peak from 2^27 to
# 2^28 entries on an NVIDIA H100 80GB HBM3 at 700.00 W. Derived before
# that from what the blocked lists of ops/isect.py (isect_tile_rows_blocked
# on 32x16 tiles wider than 2048 px: no corner-cull channel) hold when
# their stable sort runs, all int32 unless named:
#   the entry index ``e``                                        4
#   the K3 scan's 3 outputs of _segment_broadcast_multi (segment
#     start, packed rect, id; its 3 delta buffers are freed)     12
#   the entry's tile (tx, ty)                                    8
#   its camera, valid end and key base                           12
#   the valid mask (bool), the sort key, the sentinel'd ids      1 + 4 + 4
#   torch.sort: the int64 iota of values, the sorted keys and
#     int64 permutation, the radix sort's alternate buffers      8 + 12 + 12
# 77 bytes. K2 keeps no per-entry state, and the backward holds only the
# sorted ids: where the loss's blur sets the peak (a 4K step at its own
# capacity), a step takes 4.00 bytes more per entry (the same run).
BYTES_PER_ISECT_ENTRY = 77.2


def mantissa_round_cap(n: float, floor: int = 1 << 14,
                       align: int = 128) -> int:
    """Clamp to ``floor``, round up to a 1/8-power-of-two mantissa step,
    then align up to ``align``."""
    n = max(int(n), floor)
    k = max(int(np.floor(np.log2(n))) - 3, 7)
    cap = -(-n // (1 << k)) << k
    return -(-cap // align) * align


def device_bytes_limit(device) -> Optional[int]:
    """The device's memory in bytes: ``GRENDEL_HBM_GB`` (GiB) when set, as
    the JAX package reads it, else the card's total memory for a ``cuda``
    device; None on the CPU, which has no such budget."""
    env = os.environ.get("GRENDEL_HBM_GB")
    if env:
        return int(float(env) * (1 << 30))
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return None


def entry_ceiling(isect_capacity: int, step_bytes: int, limit: int,
                  bytes_per_entry: float) -> int:
    """The entry capacity a step may grow to: the capacity it ran with
    plus the entries, at ``bytes_per_entry`` each, that fit in 90% of
    ``limit`` above the ``step_bytes`` it took; never below the capacity
    it ran with (the JAX loop's ``_update_hbm_ceiling``)."""
    headroom = 0.90 * limit - step_bytes
    return max(int(isect_capacity + max(headroom, 0.0) / bytes_per_entry),
               isect_capacity)
