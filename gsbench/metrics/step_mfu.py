"""The whole training step's share of the card's float32 peak: the operations the traced steps need (counted by gsbench from the shapes and the reference's pairs: blend forward and backward, the loss, projection and SH, Adam) over the traced window times 67 TFLOP/s."""

LAYER = "whole step"
UNIT = "%"

from gsbench.counts import FP32_OPS_PER_S


def read(ev):
    if "ops" not in ev or ev["window_s"] <= 0:
        return None
    return 100.0 * ev["ops"] / (ev["window_s"] * FP32_OPS_PER_S)
