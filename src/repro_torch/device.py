"""Device resolution for the port's entry points.

Every entry point takes ``device`` (default ``"cuda"``).  Asking for
``cuda`` on a machine without a usable card raises: nothing falls back to
the CPU unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises ``RuntimeError`` when
    it names CUDA and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev
