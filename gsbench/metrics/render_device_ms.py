"""Device time of one frame: the kernels, copies and fills of a traced window, summed (not their union), over its frames."""

LAYER = "render"
UNIT = "ms"


def read(ev):
    if not ev.get("units"):
        return None
    return 1e3 * ev["device_s"] / ev["units"]
