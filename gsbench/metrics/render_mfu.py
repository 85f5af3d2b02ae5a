"""The whole frame's share of the card's float32 peak: the operations the traced frames need (counted by gsbench: the forward blend, projection and SH) over the traced window times 67 TFLOP/s."""

LAYER = "whole frame"
UNIT = "%"

from gsbench.counts import FP32_OPS_PER_S


def read(ev):
    if "ops" not in ev or ev["window_s"] <= 0:
        return None
    return 100.0 * ev["ops"] / (ev["window_s"] * FP32_OPS_PER_S)
