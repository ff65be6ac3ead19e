"""Mamba's selective scan (S6) as a hand-written CUDA kernel for Hopper.

It replaces no Pallas kernel: the reference runs the recurrence as a
``lax.scan`` (``repro/models/mamba.py:102`` is the step, ``:113``
``chunked_time_scan`` runs it over the prompt, ``:123`` ``mamba_step`` is
the decode).  On the card a scan on the hot path is a kernel:
``csrc/selective_scan.cu`` runs all S steps of a layer in one launch, the
prefill at S = the prompt and a decode step at S = 1.

For each batch row b and channel d, with the state h[d, :] (d_state
values) in f32 and a = -exp(A_log)::

    h[s] <- exp(dt[t, d] a[d, s]) h[s] + (dt[t, d] x[t, d]) B[t, s]
    y[t, d] = sum_s h[s] C[t, s] + x[t, d] D[d]

(the reference's step and its ``D`` skip, ``mamba.py:102–109``).  dt (B,
S, d_inner) f32; x (B, S, d_inner) in the compute dtype (f32 or bf16),
upcast to f32 as the reference casts ``xc``; B and C (B, S, d_state) f32;
A_log (d_inner, d_state), D (d_inner) and the state (B, d_inner, d_state)
f32; y (B, S, d_inner) f32 and the final state are returned.  d_state is
8 or 16 (:data:`STATE_SIZES`): anything else raises, on every device.

:func:`selective_scan` launches the kernel for CUDA tensors, or raises;
for tensors that lie on the CPU it runs the plain version,
:func:`selective_scan_plain`, the reference's step loop in f32 torch ops
(``RunCfg(plain_scan=True)`` takes it on any device, to compare the two).
The kernel has no backward yet: under autograd on the card it raises.
``launches`` counts kernel launches and ``plain_calls`` the plain
version's calls; nothing else adds to them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch

launches = 0
plain_calls = 0

#: the state sizes the kernel is instantiated for (jamba's SMOKE config,
#: jamba-1.5-large)
STATE_SIZES = (8, 16)
#: the C entry point's codes of x's dtype
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: f32 flops a state element a step: dt·a 1, (dt·x)·B 1, exp(·)·h + that 2,
#: h·C summed 2
FLOPS_PER_ELEMENT = 6
#: f32 flops a (step, channel): dt·x 1, x·D added 2
FLOPS_PER_CHANNEL = 3
#: the kernel's most rows (the grid's y)
MAX_ROWS = 65535

_LIB = _launch.Library("selective_scan", {
    "selective_scan_fwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]})


def check_inputs(dt, x, b, c, a_log, d, h0) -> None:
    """Refuse shapes, dtypes, devices and layouts the kernel does not
    take."""
    if dt.ndim != 3 or min(dt.shape) < 1:
        raise ValueError(f"dt must be (B, S, d_inner) with sizes >= 1, got {tuple(dt.shape)}")
    rows, s, di = dt.shape
    ds = a_log.shape[-1]
    want = {"x": (x, (rows, s, di)), "B": (b, (rows, s, ds)), "C": (c, (rows, s, ds)),
            "A_log": (a_log, (di, ds)), "D": (d, (di,)), "the state": (h0, (rows, di, ds))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if ds not in STATE_SIZES:
        raise ValueError(f"d_state {ds}: the selective_scan kernel takes {STATE_SIZES}")
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows: the selective_scan kernel takes at most {MAX_ROWS}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"selective_scan takes float32 or bfloat16 x, got {x.dtype}")
    rest = (dt, b, c, a_log, d, h0)
    if any(t.dtype != torch.float32 for t in rest):
        raise ValueError("dt, B, C, A_log, D and the state must be float32, got "
                         f"{[str(t.dtype) for t in rest]}")
    if len({t.device for t in (x,) + rest}) != 1:
        raise ValueError("selective_scan's inputs lie on different devices")
    _launch.check_contiguous("selective_scan", x, *rest)


def selective_scan_plain(dt, x, b, c, a_log, d, h0):
    """The plain PyTorch version: the reference's step loop
    (``mamba.py:102–109``) in f32, one step at a time; torch differentiates
    it under autograd.  On the card its products go through cuBLAS: keep
    TF32 off."""
    global plain_calls
    plain_calls += 1
    check_inputs(dt, x, b, c, a_log, d, h0)
    a = -torch.exp(a_log)
    xf = x.float()
    dtx = dt * xf
    h = h0
    ys = []
    for t in range(dt.shape[1]):
        h = torch.exp(dt[:, t, :, None] * a) * h + dtx[:, t, :, None] * b[:, t, None, :]
        ys.append(torch.matmul(h, c[:, t, :, None])[..., 0])
    return torch.stack(ys, 1) + xf * d, h


def selective_scan(dt, x, b, c, a_log, d, h0):
    """The recurrence over all S steps from the state ``h0``: returns ``(y,
    final state)``, both new f32 tensors.  One kernel launch for CUDA
    tensors; the plain version for CPU tensors."""
    check_inputs(dt, x, b, c, a_log, d, h0)
    if _launch.runs_plain("selective_scan", dt):
        return selective_scan_plain(dt, x, b, c, a_log, d, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (dt, x, b, c, a_log, d, h0)):
        raise NotImplementedError("selective_scan has no backward kernel yet: Jamba's "
                                  "training is ROADMAP Queue 1 item 11.6d")
    return _kernel(dt, x, b, c, a_log, d, h0)


def _kernel(dt, x, b, c, a_log, d, h0):
    """One launch of the CUDA kernel: y and the state in new tensors."""
    global launches
    rows, s, di = dt.shape
    y = torch.empty((rows, s, di), dtype=torch.float32, device=dt.device)
    h_out = torch.empty_like(h0)
    _launch.launch("selective_scan", _LIB.fn("selective_scan_fwd"), dt.device,
                   dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
                   a_log.data_ptr(), d.data_ptr(), h0.data_ptr(), y.data_ptr(),
                   h_out.data_ptr(), rows, s, di, a_log.shape[-1], _DTYPES[x.dtype],
                   detail=f"dt {tuple(dt.shape)}, x {x.dtype}")
    launches += 1
    return y, h_out


def selective_scan_bytes(b: int, s: int, di: int, ds: int, itemsize: int) -> int:
    """The bytes the function must move: dt (f32) and x (``itemsize``)
    read once, y written once (f32), B and C read, A_log and D read, the
    state read and written."""
    n = b * s * di
    return n * (4 + itemsize + 4) + 2 * b * s * ds * 4 + (di * ds + di) * 4 + \
        2 * b * di * ds * 4


def selective_scan_flops(b: int, s: int, di: int, ds: int) -> int:
    """The f32 flops the function needs: :data:`FLOPS_PER_ELEMENT` a state
    element a step and :data:`FLOPS_PER_CHANNEL` a (step, channel); its
    exps apart (:func:`selective_scan_exps`)."""
    return (FLOPS_PER_ELEMENT * ds + FLOPS_PER_CHANNEL) * b * s * di


def selective_scan_exps(b: int, s: int, di: int, ds: int) -> int:
    """The exponentials the function needs: one a state element a step
    (the special function units' work)."""
    return b * s * di * ds
