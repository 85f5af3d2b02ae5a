"""Device ms a training step under the program's ``optimizer`` span: the optimizer (the visibility normalisation, the division by bsz, the densify statistics, the LR schedule and Adam); kernels, copies and fills summed (gsbench/spans.py)."""

LAYER = "optimizer"
UNIT = "ms"
SPAN = "optimizer"


def read(ev):
    s = ev.get("spans", {}).get(SPAN)
    if s is None or not ev.get("units"):
        return None
    return 1e3 * s["device_s"] / ev["units"]
