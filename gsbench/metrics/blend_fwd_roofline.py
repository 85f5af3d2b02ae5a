"""K1's share of its roofline: the least time the card could take for the forward blend of the traced steps or frames (the larger of its operations and bytes, counted by gsbench from the reference's walk of the same inputs) over K1's device time."""

LAYER = "blend"
UNIT = "%"
KERNELS = ("rasterize_fwd_kernel",)


def read(ev):
    if "blend_fwd_bound_s" not in ev:
        return None
    t = sum(s for name, s in ev["kernel_s"].items()
            if any(k in name for k in KERNELS))
    if t <= 0:
        return None
    return 100.0 * ev["blend_fwd_bound_s"] / t
