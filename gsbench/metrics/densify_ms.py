"""Host ms of one densify round: the loop's ``80 densify`` span, its capacity growth and its readback included (gsbench/spans.py)."""

LAYER = "densify"
UNIT = "ms"
SPAN = "80 densify"


def read(ev):
    s = ev.get("spans", {}).get(SPAN)
    if s is None or not s["count"]:
        return None
    return 1e3 * s["host_s"] / s["count"]
