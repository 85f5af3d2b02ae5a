"""Kernel launches of one training step in a traced window (copies and fills not counted)."""

LAYER = "training step"
UNIT = "count"


def read(ev):
    if not ev.get("units"):
        return None
    return ev["launches"] / ev["units"]
