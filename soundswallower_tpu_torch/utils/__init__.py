"""Small helpers shared by the port's modules."""

import numpy as np
import torch


def to_device(a, dtype, device) -> torch.Tensor:
    """A host array as a tensor of numpy dtype ``dtype`` on ``device``
    (always a fresh, writable, C-contiguous copy)."""
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)
