"""Synchronizing calls of one step of the training loop (an item, a blocking copy), counted under torch.cuda.set_sync_debug_mode("warn") over a run of steps after the traced window."""

LAYER = "training loop"
UNIT = "count"


def read(ev):
    return ev.get("syncs_per_step")
