"""Host ms a step inside the loop's ``iteration`` spans but outside ``50 step``, ``80 densify``, ``90 eval`` and ``save``: batch, ground truth, capacity check and log (gsbench/spans.py)."""

LAYER = "training loop"
UNIT = "ms"
SPAN = "iteration"
OUT = ("50 step", "80 densify", "90 eval", "save")


def read(ev):
    spans = ev.get("spans", {})
    if SPAN not in spans or not ev.get("units"):
        return None
    s = spans[SPAN]["host_s"] - sum(spans[k]["host_s"] for k in OUT
                                    if k in spans)
    return 1e3 * s / ev["units"]
