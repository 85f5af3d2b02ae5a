"""Host-clock seconds of the scene's load in set-up: COLMAP parse and every view's JPEG decode (and resize on the card, where the -r rule resizes)."""

LAYER = "image decode and ground truth"
UNIT = "s"


def read(ev):
    return ev.get("scene_load_s")
