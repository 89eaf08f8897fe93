"""Device helpers of the reference's frozen copies."""

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; "cuda" needs a CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} but no CUDA device is "
                           "available")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def to_device(a, dtype, device) -> torch.Tensor:
    """A host array as a fresh C-contiguous tensor of numpy dtype
    ``dtype`` on ``device``."""
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)
