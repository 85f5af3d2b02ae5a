"""Device ms a training step under the program's ``projection`` span: the projection (activation, projection and SH evaluation, the densify statistics' tap), forward and backward; kernels, copies and fills summed (gsbench/spans.py)."""

LAYER = "projection"
UNIT = "ms"
SPAN = "projection"


def read(ev):
    s = ev.get("spans", {}).get(SPAN)
    if s is None or not ev.get("units"):
        return None
    return 1e3 * s["device_s"] / ev["units"]
