"""Tile-list entries of one view: the mean over the traced steps of each step's own num_isects (the count the trainer's capacity telemetry reads) over the batch size."""

LAYER = "tile lists"
UNIT = "count"


def read(ev):
    return ev.get("entries_per_view")
