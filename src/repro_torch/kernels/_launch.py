"""What every kernel wrapper of the port does around its launch.

Each wrapper checks its inputs, runs its plain version for a tensor that
lies on the CPU, and otherwise launches its CUDA kernel from a library
built at first use (:mod:`repro_torch.kernels._build`), through ``ctypes``,
on PyTorch's current stream (or a stream it names), raising when the
launch is refused.  The C entry points all return a CUDA error code and
take the stream as their last argument.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: launches index rows (or elements) with 32-bit grid coordinates
MAX_ROWS = 2 ** 31 - 1


class Library:
    """``csrc/<name>.cu`` built and loaded at first use, with the ctypes
    signature of every entry point declared once: ``signatures`` maps an
    entry point to its ``argtypes`` (``restype`` is ``c_int``)."""

    def __init__(self, name: str, signatures: dict[str, list]):
        self.name = name
        self._signatures = signatures
        self._lib = None

    def fn(self, entry: str):
        if self._lib is None:
            lib = _build.load(self.name)
            for e, argtypes in self._signatures.items():
                f = getattr(lib, e)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            self._lib = lib
        return getattr(self._lib, entry)


def check_pair(x_re: torch.Tensor, x_im: torch.Tensor) -> None:
    """The two halves of a planar complex tensor must match."""
    if x_re.shape != x_im.shape or x_re.dtype != x_im.dtype \
            or x_re.device != x_im.device:
        raise ValueError("x_re and x_im must share shape, dtype and device: "
                         f"{tuple(x_re.shape)}/{x_re.dtype}/{x_re.device} vs "
                         f"{tuple(x_im.shape)}/{x_im.dtype}/{x_im.device}")


def runs_plain(who: str, x: torch.Tensor) -> bool:
    """True for a tensor on the CPU (the wrapper runs its plain version),
    False for one on a CUDA card (it launches its kernel); raises for any
    other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{who} runs on cuda or cpu tensors, got {x.device}")
    return False


def dtype_suffix(who: str, dtype: torch.dtype) -> str:
    """``"f32"`` or ``"f64"``, the suffix of the typed entry points."""
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise ValueError(f"{who} takes float32 or float64, got {dtype}")


def check_contiguous(who: str, *xs: torch.Tensor) -> None:
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{who} needs contiguous inputs")


def check_rows(rows: int) -> None:
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows exceed the grid limit of 2**31 - 1")


def launch(who: str, fn, device: torch.device, *args, stream=None,
           detail: str = "") -> None:
    """Call the C entry point ``fn(*args, stream)`` with ``device`` current;
    ``stream`` defaults to PyTorch's current stream there.  Raises when it
    returns a CUDA error (a refused launch)."""
    with torch.cuda.device(device):
        s = stream if stream is not None else torch.cuda.current_stream()
        err = fn(*args, s.cuda_stream)
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: CUDA error {err} "
                           f"({detail})")
