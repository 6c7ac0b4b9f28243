"""The port's default-device rule, shared by every module that places
work: the first CUDA device unless the caller names another, and no
silent fall-back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device a render runs on: `device`, by default the first CUDA
    device.  Raises RuntimeError when that is a CUDA device and none is
    available: a render goes to the CPU only when asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device available for {dev}: pass device='cpu' to "
            "render on the CPU")
    return dev
