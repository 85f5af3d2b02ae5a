"""Host ms a step inside the loop's ``50 step`` span: the enqueue of the step's launches and the waits of its synchronizing calls (gsbench/spans.py)."""

LAYER = "training step"
UNIT = "ms"
SPAN = "50 step"


def read(ev):
    s = ev.get("spans", {}).get(SPAN)
    if s is None or not ev.get("units"):
        return None
    return 1e3 * s["host_s"] / ev["units"]
