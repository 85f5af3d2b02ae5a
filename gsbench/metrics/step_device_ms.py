"""Device time of one training step: the kernels, copies and fills of a traced window, summed (not their union), over its steps."""

LAYER = "training step"
UNIT = "ms"


def read(ev):
    if not ev.get("units"):
        return None
    return 1e3 * ev["device_s"] / ev["units"]
