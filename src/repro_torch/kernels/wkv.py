"""RWKV-6's WKV recurrence as a hand-written CUDA kernel for Hopper.

It replaces no Pallas kernel: the reference runs the recurrence as a
``lax.scan`` (``repro/models/rwkv.py:90``, ``rwkv_time_mix_seq``; its step
``rwkv_time_mix_step`` :61).  On the card a scan on the hot path is a
kernel: ``csrc/wkv6.cu`` runs all S steps of a layer in one launch, the
prefill at S = the prompt and a decode step at S = 1.

For each batch row and head, with the (K, K) state s (row i k's channel,
column j v's), in f32::

    y[t, j] = sum_i r[t, i] * (s[i, j] + u[i] * k[t, i] * v[t, j])
    s[i, j] <- w[t, i] * s[i, j] + k[t, i] * v[t, j]

(the kernel takes the bonus as one dot a step, ``v[t, j] * sum_i r[t, i]
u[i] k[t, i]``).  r, k, v are (B, S, H, K) in the compute dtype (f32 or bf16), w (B, S, H,
K) f32 (the data-dependent decay), u (H, K) f32 (the bonus) and the state
(B, H, K, K) f32; y (B, S, H, K) f32 and the final state are returned.  K
is 16 or 64 (:data:`HEAD_SIZES`): anything else raises, on every device.

:func:`wkv6` launches the kernel for CUDA tensors, or raises; for tensors
that lie on the CPU it runs the plain version, :func:`wkv6_plain`, the
reference's step loop in f32.  Neither runs under autograd: training
needs the kernel's backward (ROADMAP Queue 1 item 11.6b).  ``launches``
counts kernel launches and ``plain_calls`` plain-version calls; nothing
else adds to either.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch

launches = 0
plain_calls = 0

#: the head sizes the kernel is instantiated for (rwkv6-3b's SMOKE config, rwkv6-3b)
HEAD_SIZES = (16, 64)
#: the C entry point's codes of r, k and v's dtype
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: f32 flops a state element a step: r·s 2, k·v 1, w·s + kv 2 (the bonus
#: ``sum_i r_i u_i k_i v_j`` is ``v_j`` times one dot a step: O(K), not O(K²))
FLOPS_PER_ELEMENT = 5
#: f32 flops a (step, head, column j): the dot's 3 a term, spread over its K
#: columns, and ``v_j·d`` added 2
FLOPS_PER_COLUMN = 5

_LIB = _launch.Library("wkv6", {"wkv6_fwd": (
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])})


def check_inputs(r, k, v, w, u, state) -> None:
    """Refuse shapes, dtypes, devices and layouts the kernel does not
    take, and autograd."""
    if r.ndim != 4:
        raise ValueError(f"r must be (B, S, H, K), got {tuple(r.shape)}")
    b, s, h, kk = r.shape
    if min(b, s, h) < 1:
        raise ValueError(f"wkv6 needs B, S, H >= 1, got r {tuple(r.shape)}")
    if any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"k {tuple(k.shape)}, v {tuple(v.shape)} and w {tuple(w.shape)} "
                         f"must be r's {tuple(r.shape)}")
    if tuple(u.shape) != (h, kk) or tuple(state.shape) != (b, h, kk, kk):
        raise ValueError(f"u must be (H, K) = {(h, kk)} and the state (B, H, K, K) = "
                         f"{(b, h, kk, kk)}; got {tuple(u.shape)}, {tuple(state.shape)}")
    if kk not in HEAD_SIZES:
        raise ValueError(f"head size {kk}: the wkv6 kernel takes {HEAD_SIZES}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError("wkv6 takes float32 or bfloat16 r, k, v of one dtype, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    if any(x.dtype != torch.float32 for x in (w, u, state)):
        raise ValueError(f"w, u and the state must be float32, got {w.dtype}, {u.dtype}, "
                         f"{state.dtype}")
    if len({x.device for x in (r, k, v, w, u, state)}) != 1:
        raise ValueError("wkv6's inputs lie on different devices")
    if not all(x.is_contiguous() for x in (r, k, v, w, u, state)):
        raise ValueError("wkv6 needs contiguous inputs")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (r, k, v, w, u, state)):
        raise NotImplementedError(
            "wkv6 under autograd: the kernel's backward (RWKV training) is not ported "
            "yet (ROADMAP Queue 1 item 11.6b)")


def wkv6_plain(r, k, v, w, u, state):
    """The plain PyTorch version: the reference's step loop
    (``rwkv.py:80–84``) in f32, one step at a time.  On the card its
    products go through cuBLAS: keep TF32 off."""
    global plain_calls
    plain_calls += 1
    check_inputs(r, k, v, w, u, state)
    b, s, h, kk = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    st = state.clone()
    uu = u[None, :, :, None]
    y = torch.empty((b, s, h, kk), dtype=torch.float32, device=r.device)
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        y[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], st + uu * kv)
        st = w[:, t, :, :, None] * st + kv
    return y, st


def wkv6(r, k, v, w, u, state):
    """The recurrence over all S steps of ``r``, ``k``, ``v``, ``w`` from
    ``state``: returns ``(y, final state)``, both new f32 tensors.  One
    kernel launch for CUDA tensors; the plain version for CPU tensors."""
    check_inputs(r, k, v, w, u, state)
    if _launch.runs_plain("wkv6", r):
        return wkv6_plain(r, k, v, w, u, state)
    return _kernel(r, k, v, w, u, state)


def _kernel(r, k, v, w, u, state):
    """One launch of the CUDA kernel: y and the state in new tensors."""
    global launches
    b, s, h, kk = r.shape
    y = torch.empty((b, s, h, kk), dtype=torch.float32, device=r.device)
    s_out = torch.empty_like(state)
    _launch.launch("wkv6", _LIB.fn("wkv6_fwd"), r.device, r.data_ptr(), k.data_ptr(),
                   v.data_ptr(), w.data_ptr(), u.data_ptr(), state.data_ptr(),
                   y.data_ptr(), s_out.data_ptr(), b, s, h, kk, _DTYPES[r.dtype],
                   detail=f"r {tuple(r.shape)} {r.dtype}")
    launches += 1
    return y, s_out


def wkv6_bytes(b: int, s: int, h: int, kk: int, itemsize: int) -> int:
    """The bytes the function must move: r, k, v (``itemsize`` each) and w
    read once, y written once (f32), the state read and written, u read."""
    n = b * s * h * kk
    return 3 * n * itemsize + 2 * n * 4 + 2 * b * h * kk * kk * 4 + h * kk * 4


def wkv6_flops(b: int, s: int, h: int, kk: int) -> int:
    """The f32 flops the function needs: :data:`FLOPS_PER_ELEMENT` a state
    element a step and :data:`FLOPS_PER_COLUMN` a state column a step."""
    return (FLOPS_PER_ELEMENT * kk + FLOPS_PER_COLUMN) * b * s * h * kk
