"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Any

import torch


def resolve_device(device: Any) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA raises
    (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev
