"""Device resolution for the port's entry points.

``cuda`` is the default.  ``cpu`` is taken only when the caller names it:
a missing GPU is an error, never a silent switch to the CPU.
"""

from __future__ import annotations

import torch


def default_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve ``device`` (default ``"cuda"``) and check that it exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
