"""Share of a traced window (of training steps, loop steps or frames) in which no kernel, copy or fill ran on the card: one minus the union of the device's intervals over the window."""

LAYER = "device"
UNIT = "%"


def read(ev):
    if ev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ev["busy_s"] / ev["window_s"])
