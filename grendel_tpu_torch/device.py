"""Device choice for the package's entry points.

Entry points run on the card (``"cuda"``) unless the caller passes
``device="cpu"``. Asking for the card on a machine without one raises:
nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU")
    return dev
