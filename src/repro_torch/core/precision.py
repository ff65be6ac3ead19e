"""Precision policy of the port: dtype resolution.

The reference gates float64 on ``jax_enable_x64`` (``repro.core.precision``).
PyTorch always computes in the dtype it is given, so the gate reduces to
canonicalising the requested dtype; a non-float dtype is still refused.
"""

from __future__ import annotations

import numpy as np
import torch


def default_real_dtype() -> torch.dtype:
    """The widest real dtype the port computes in."""
    return torch.float64


def require_dtype(dtype, *, who: str = "FFT3DPlan") -> np.dtype:
    """``dtype`` (numpy, torch or a name) as a canonical floating numpy dtype;
    ``ValueError`` for anything that is not a real floating type."""
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).removeprefix("torch.")
    try:
        want = np.dtype(dtype)
    except TypeError as e:
        raise ValueError(f"{who}: unknown dtype {dtype!r}") from e
    if want.kind != "f":
        raise ValueError(f"{who}: dtype must be a real floating type, "
                         f"got {want.name}")
    return want


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a floating numpy dtype (or its name)."""
    return getattr(torch, require_dtype(dtype, who="torch_dtype").name)
