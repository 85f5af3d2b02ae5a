"""Device ms a training step under the program's ``loss`` span: the loss (the ground truth to float, L1 and the SSIM blur), forward and backward; kernels, copies and fills summed (gsbench/spans.py)."""

LAYER = "loss"
UNIT = "ms"
SPAN = "loss"


def read(ev):
    s = ev.get("spans", {}).get(SPAN)
    if s is None or not ev.get("units"):
        return None
    return 1e3 * s["device_s"] / ev["units"]
