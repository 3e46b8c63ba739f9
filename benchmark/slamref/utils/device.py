"""The device the port's entry points default to: the CUDA card."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card. Raises
    when none is present: the CPU runs only when asked for by name
    (``device="cpu"``), never as a quiet fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
