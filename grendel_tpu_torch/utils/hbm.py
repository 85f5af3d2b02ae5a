"""Entry-capacity sizing and the device-memory budget of the tile lists.

The port's copies of what the trainer's capacity tuner takes from
grendel_tpu/utils/hbm.py: ``mantissa_round_cap``, the one rounding rule
the tuner and the benchmarks use to size the tile-list entry buffers, and
the budget model behind the entry ceiling (``Trainer._update_hbm_ceiling``):
the device's memory (:func:`device_bytes_limit`), the bytes a step takes
for each entry of capacity (``BYTES_PER_ISECT_ENTRY`` on the
camera-blocked lists, ``BYTES_PER_FLAT_ENTRY`` on a rank's flat lists)
and the ceiling they give (:func:`entry_ceiling`), clamped so that int32
entry offsets cannot overflow (``ENTRY_CAP_MAX``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

# Device bytes a training step takes for each tile-list entry of its
# capacity, where the entries set the step's peak, for each layout of
# the lists. Measured by chip_smoke.py phase 13 on an NVIDIA H100 80GB
# HBM3 at 700.00 W as the growth of a 4K step's peak from 2^27 to 2^28
# entries:
#
# The camera-blocked lists of the one-device step (and of a rank at world
# size 1): 77.19. The isect sets the peak. What isect_tile_rows_blocked (32x16 tiles wider
# than 2048 px: no corner-cull channel) holds when its stable sort runs,
# all int32 unless named:
#   the entry index ``e``                                        4
#   the K3 scan's 3 outputs of _segment_broadcast_multi (segment
#     start, packed rect, id; its 3 delta buffers are freed)     12
#   the entry's tile (tx, ty)                                    8
#   its camera, valid end and key base                           12
#   the valid mask (bool), the sort key, the sentinel'd ids      1 + 4 + 4
#   torch.sort: the int64 iota of values, the sorted keys and
#     int64 permutation, the radix sort's alternate buffers      8 + 12 + 12
# 77 bytes. The backward holds less: the saved ids (4), their stable sort
# for K2s (the sorted ids 4 and int64 permutation 8, with the sort's iota
# and alternate buffers, 20 more, freed before the rows exist), and K2's
# rows (36, zeroed by a memset, no more memory): 52 bytes an entry at
# most. Where the loss's blur sets the peak (a 4K step at its own
# capacity), a step takes 4.00 bytes more per entry (the same run).
BYTES_PER_ISECT_ENTRY = 77.2
# The flat row-span lists that a rank builds at D > 1 (ops/isect.py
# isect_tile_rows), taken by MultiRankTrainer there: 69.19, on a
# simulated D=2 step (both ranks in one process), 10% below the blocked
# lists'. The isect sets the peak again: ``e`` 4, the scan's 4 outputs
# (segment start, packed rect, id, camera) 16, (tx, ty) 8, the slot 4,
# the valid mask 1 and the sort's 32: 65 bytes; the simulation adds rank
# 0's saved ids (4) while rank 1 builds its lists, so a rank alone takes
# a little less and the constant errs on the safe side.
BYTES_PER_FLAT_ENTRY = 69.2


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


# The largest entry capacity a ceiling may give: 2^31 - 2^27 =
# 2,013,265,920. Entry positions, tile offsets and spans are int32
# (ops/isect.py), so a capacity and everything added on top of it must
# stay at or below 2^31 - 1. What the code adds on top of a capacity:
#   * the layouts of ops/isect.py: nothing. The blocked lists take
#     capacity // n_cams entries a camera (isect_tile_rows_blocked,
#     Trainer.render_config), compaction only shrinks them, and the
#     largest int32 an entry list holds is the capacity itself: the spare
#     position of _delta_buf's clamp and the last span's end;
#   * Trainer._round_cap: nothing, since it clamps after the mantissa
#     rounding and the 128 * bsz alignment;
#   * a re-rounding of a capacity that stands at the ceiling, as
#     Trainer._restore_tuner_state does on resume: the mantissa step,
#     2^27 for a capacity in [2^30, 2^31), and the alignment to 128 * bsz.
#     2^31 - 2^27 is itself a multiple of 2^27, so the mantissa rounding
#     keeps it, as does the alignment for a power-of-two bsz; another bsz
#     adds less than 128 * bsz, inside the 2^27 - 1 left below 2^31 - 1
#     for any bsz below 2^20.
ENTRY_CAP_MAX = (1 << 31) - (1 << 27)


def entry_ceiling(isect_capacity: int, step_bytes: int, limit: int,
                  bytes_per_entry: float) -> int:
    """The entry capacity a step may grow to: the capacity it ran with
    plus the entries, at ``bytes_per_entry`` each, that fit in 90% of
    ``limit`` above the ``step_bytes`` it took; never below the capacity
    it ran with (the JAX loop's ``_update_hbm_ceiling``), and never above
    ``ENTRY_CAP_MAX``, where int32 entry offsets would overflow (the JAX
    loop's formula has no such bound)."""
    headroom = 0.90 * limit - step_bytes
    ceiling = max(int(isect_capacity + max(headroom, 0.0) / bytes_per_entry),
                  isect_capacity)
    return min(ceiling, ENTRY_CAP_MAX)
