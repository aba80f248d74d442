"""The device an entry point runs on: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``. Raises when it names CUDA and no
    card is there: nothing carries on on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for (the default) but CUDA is "
            "not available; pass device='cpu' to run on the CPU")
    return device
