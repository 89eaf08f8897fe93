"""Small helpers shared by the port's modules."""

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` (the default of
    every entry point) raises where no CUDA device is available, so a
    caller never gets the CPU without asking for it."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={str(device)!r} but no CUDA device "
                               "is available")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def to_device(a, dtype, device) -> torch.Tensor:
    """A host array as a tensor of numpy dtype ``dtype`` on ``device``
    (always a fresh, writable, C-contiguous copy)."""
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)
