"""Device selection (an explicit device, and no silent move to the CPU),
and the copies between host memory and the card that the port counts."""

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


def _uploaded(out: torch.Tensor, x) -> torch.Tensor:
    """`out`; when it was copied from host memory to the card, its bytes
    and the copy's host wait are counted (utils/profiling.py)."""
    if out.is_cuda and out.numel() and not (isinstance(x, torch.Tensor)
                                            and x.is_cuda):
        # imported here: the utils package imports core, which imports this
        # module
        from otslam_tpu_torch.utils.profiling import count
        count("h2d_bytes", out.numel() * out.element_size())
        count("syncs")
    return out


def to_f32(x, dev: torch.device) -> torch.Tensor:
    """A float32 tensor of `x` (array, nested list or tensor) on `dev`."""
    if isinstance(x, torch.Tensor):
        return _uploaded(x.to(device=dev, dtype=torch.float32), x)
    return _uploaded(torch.as_tensor(np.asarray(x, np.float32), device=dev),
                     x)


def to_device(x, dev: torch.device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=dev)``, its copy to the card
    counted as `to_f32`'s."""
    return _uploaded(torch.as_tensor(x, dtype=dtype, device=dev), x)


def to_host(t: torch.Tensor) -> np.ndarray:
    """`t` as a host array; a copy from the card counts its bytes and its
    host wait (utils/profiling.py)."""
    if t.is_cuda and t.numel():
        from otslam_tpu_torch.utils.profiling import count
        count("d2h_bytes", t.numel() * t.element_size())
        count("syncs")
    return t.cpu().numpy()
