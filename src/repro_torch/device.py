"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: with no
device given they pick ``cuda`` and raise when there is none, so a run that
was meant for the card never carries on quietly on the host.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the GPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host")
    return torch.device("cuda")
