"""The blend backward's share of its roofline: the least time the card could take for K2's operations and bytes and K2s's bytes of the traced steps (counted by gsbench from the reference's walk) over the device time of K2 and K2s."""

LAYER = "blend backward"
UNIT = "%"
KERNELS = ("rasterize_bwd_kernel", "segment_sum_kernel")


def read(ev):
    if "blend_bwd_bound_s" not in ev:
        return None
    t = sum(s for name, s in ev["kernel_s"].items()
            if any(k in name for k in KERNELS))
    if t <= 0:
        return None
    return 100.0 * ev["blend_bwd_bound_s"] / t
