"""Device ms a training step under the program's ``tile lists`` span: the tile lists (the entries' keys, the sort, the tile ranges and the compaction); kernels, copies and fills summed (gsbench/spans.py)."""

LAYER = "tile lists"
UNIT = "ms"
SPAN = "tile lists"


def read(ev):
    s = ev.get("spans", {}).get(SPAN)
    if s is None or not ev.get("units"):
        return None
    return 1e3 * s["device_s"] / ev["units"]
