"""Entry-capacity sizing.

The port's copy of ``mantissa_round_cap`` from grendel_tpu/utils/hbm.py:
the one rounding rule the trainer's capacity tuner and the benchmarks use
to size the tile-list entry buffers.
"""

from __future__ import annotations

import numpy as np


def mantissa_round_cap(n: float, floor: int = 1 << 14,
                       align: int = 128) -> int:
    """Clamp to ``floor``, round up to a 1/8-power-of-two mantissa step,
    then align up to ``align``."""
    n = max(int(n), floor)
    k = max(int(np.floor(np.log2(n))) - 3, 7)
    cap = -(-n // (1 << k)) << k
    return -(-cap // align) * align
