"""Device selection shared by the port's entry points."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor_on"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. Without a card, ``None`` or a CUDA
    device raises: the port never carries on quietly on the CPU, which
    runs only when the caller asks for it with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def as_tensor_on(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A contiguous tensor of ``dtype`` on ``device``: tensors are moved,
    anything else (numpy arrays, which may be read-only) is copied."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x), dtype=dtype)
    return x.to(device=device, dtype=dtype).contiguous()
