"""Device selection: an explicit device, and no silent move to the CPU."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """torch.device for `device` (None -> "cuda:0", the card). A CUDA device
    on a machine without CUDA raises: the port never falls back to the CPU
    on its own; only an explicit "cpu" runs there."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available "
            f"(torch {torch.__version__}); pass device='cpu' to run the "
            "plain PyTorch path")
    return dev


def to_f32(x, dev: torch.device) -> torch.Tensor:
    """A float32 tensor of `x` (array, nested list or tensor) on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)
