"""RWKV-6's WKV recurrence and its gradient as hand-written CUDA kernels
for Hopper.

They replace no Pallas kernel: the reference runs the recurrence as a
``lax.scan`` (``repro/models/rwkv.py:90``, ``rwkv_time_mix_seq``; its step
``rwkv_time_mix_step`` :61) and differentiates it with ``jax.grad``.  On
the card a scan on the hot path is a kernel: ``csrc/wkv6.cu`` runs all S
steps of a layer in one launch, the prefill at S = the prompt and a decode
step at S = 1, and its backward in one more.

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
reference's step loop in f32.  Under autograd (grad enabled and an input
that requires it) it goes through :class:`WKV6`: the forward also keeps
the state at every :data:`CKPT_STEPS`-th step (the kernel's form of the
reference's chunked remat of the time scan), and the backward is
:func:`wkv6_bwd`, the ``wkv6_bwd`` kernel on the card and
:func:`wkv6_backward_plain` (the same dataflow in torch ops) on the CPU.
Without grad, :func:`wkv6` is the plain call or one launch, as before.
:func:`wkv6_plain` itself runs under autograd too: torch then
differentiates its step loop (``RunCfg(plain_wkv=True)``, the control the
kernels are held to).  ``launches`` and ``bwd_launches`` count kernel
launches, ``plain_calls`` and ``plain_bwd_calls`` the plain versions'
calls; nothing else adds to them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch

launches = 0
plain_calls = 0
bwd_launches = 0
plain_bwd_calls = 0

#: the head sizes the kernel is instantiated for (rwkv6-3b's SMOKE config, rwkv6-3b)
HEAD_SIZES = (16, 64)
#: the C entry point's codes of r, k and v's dtype
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: steps between two checkpoints of the state under autograd (``CKPT`` in
#: ``csrc/wkv6.cu``): (B, ceil(S / 16), H, K, K) f32, 168 MB a layer at B=8,
#: S=512, H=40, K=64
CKPT_STEPS = 16
#: f32 flops a state element a step: r·s 2, k·v 1, w·s + kv 2 (the bonus
#: ``sum_i r_i u_i k_i v_j`` is ``v_j`` times one dot a step: O(K), not O(K²))
FLOPS_PER_ELEMENT = 5
#: f32 flops a (step, head, column j): the dot's 3 a term, spread over its K
#: columns, and ``v_j·d`` added 2
FLOPS_PER_COLUMN = 5
#: the backward's f32 flops a state element a step: dr, dk, dv, dw 2 each,
#: ds's update 3 (``w·ds + r·dy``)
BWD_FLOPS_PER_ELEMENT = 11
#: the backward's f32 flops a (step, head, channel): g's and b's dots (2 and
#: 3 a term), the u terms of dr, dk and du (3 each) and dv's ``dy·b`` (2)
BWD_FLOPS_PER_COLUMN = 16

_LIB = _launch.Library("wkv6", {
    "wkv6_fwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "wkv6_bwd": [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_void_p]})


def _dims(r) -> tuple:
    if r.ndim != 4:
        raise ValueError(f"r must be (B, S, H, K), got {tuple(r.shape)}")
    if min(r.shape[:3]) < 1:
        raise ValueError(f"wkv6 needs B, S, H >= 1, got r {tuple(r.shape)}")
    return tuple(r.shape)


def _check(r, k, v, w, u, f32: dict) -> None:
    """r, k, v, w and u as the kernels take them, and ``f32`` ({name:
    (tensor, shape)}) float32 tensors of those shapes, on r's device."""
    b, s, h, kk = r.shape
    if any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"k {tuple(k.shape)}, v {tuple(v.shape)} and w {tuple(w.shape)} "
                         f"must be r's {tuple(r.shape)}")
    for name, (x, shape) in dict(f32, u=(u, (h, kk))).items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if kk not in HEAD_SIZES:
        raise ValueError(f"head size {kk}: the wkv6 kernel takes {HEAD_SIZES}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError("wkv6 takes float32 or bfloat16 r, k, v of one dtype, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    rest = [w, u] + [x for x, _ in f32.values()]
    if any(x.dtype != torch.float32 for x in rest):
        raise ValueError(f"w, u, {', '.join(f32)} must be float32, got "
                         f"{[str(x.dtype) for x in rest]}")
    if len({x.device for x in [r, k, v] + rest}) != 1:
        raise ValueError("wkv6's inputs lie on different devices")
    if not all(x.is_contiguous() for x in [r, k, v] + rest):
        raise ValueError("wkv6 needs contiguous inputs")


def check_inputs(r, k, v, w, u, state) -> None:
    """Refuse shapes, dtypes, devices and layouts the kernel does not
    take."""
    b, _, h, kk = _dims(r)
    _check(r, k, v, w, u, {"the state": (state, (b, h, kk, kk))})


def checkpoint_count(s: int) -> int:
    """The states the forward keeps under autograd over ``s`` steps."""
    return -(-s // CKPT_STEPS)


def check_grad_inputs(r, k, v, w, u, ckpts, dy, ds) -> None:
    """Refuse what :func:`wkv6_bwd` does not take: the forward's inputs as
    :func:`check_inputs`, its checkpoints (B, ceil(S / CKPT_STEPS), H, K,
    K), dy (B, S, H, K) and the final state's gradient ``ds`` (B, H, K, K)
    or None, all f32 and contiguous on r's device."""
    b, s, h, kk = _dims(r)
    f32 = {"the checkpoints": (ckpts, (b, checkpoint_count(s), h, kk, kk)),
           "dy": (dy, (b, s, h, kk))}
    if ds is not None:
        f32["dS"] = (ds, (b, h, kk, kk))
    _check(r, k, v, w, u, f32)


def wkv6_plain(r, k, v, w, u, state, *, checkpoints: bool = False):
    """The plain PyTorch version: the reference's step loop
    (``rwkv.py:80–84``) in f32, one step at a time; torch differentiates
    it under autograd.  With ``checkpoints`` it also returns the state
    entering every :data:`CKPT_STEPS`-th step, (B, ceil(S / CKPT_STEPS), H,
    K, K), as the kernel keeps them.  On the card its products go through
    cuBLAS: keep TF32 off."""
    global plain_calls
    plain_calls += 1
    check_inputs(r, k, v, w, u, state)
    s = r.shape[1]
    # r and v as rows, k and w as columns, so that a step is plain products
    # and one matmul (the reference's einsum, the same bits, less host time:
    # the host issues a step's ops one by one on the card)
    rf, kf, vf = r.float().unsqueeze(-2), k.float().unsqueeze(-1), v.float().unsqueeze(-2)
    wc = w.unsqueeze(-1)
    st = state.clone()
    uu = u[None, :, :, None]
    ys, kept = [], []
    for t in range(s):
        if checkpoints and t % CKPT_STEPS == 0:
            kept.append(st)
        kv = kf[:, t] * vf[:, t]
        ys.append(torch.matmul(rf[:, t], st + uu * kv))
        st = wc[:, t] * st + kv
    y = torch.stack(ys, 1).squeeze(-2)
    return (y, st, torch.stack(kept, 1)) if checkpoints else (y, st)


def wkv6_backward_plain(r, k, v, w, u, ckpts, dy, ds=None):
    """The plain version of :func:`wkv6_bwd`, in f32 torch ops, with the
    kernel's dataflow: the chunks of :data:`CKPT_STEPS` steps from the last,
    each chunk's states recomputed from its checkpoint, then its steps
    walked backward (``csrc/wkv6.cu`` states the formulas)."""
    global plain_bwd_calls
    plain_bwd_calls += 1
    check_grad_inputs(r, k, v, w, u, ckpts, dy, ds)
    b, s, h, kk = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    ds = torch.zeros((b, h, kk, kk), dtype=torch.float32, device=r.device) \
        if ds is None else ds.clone()
    dr, dk, dv, dw = (torch.empty((b, s, h, kk), dtype=torch.float32, device=r.device)
                      for _ in range(4))
    du = torch.zeros((b, h, kk), dtype=torch.float32, device=r.device)
    for c0 in reversed(range(checkpoint_count(s))):
        t0 = c0 * CKPT_STEPS
        steps = range(t0, min(t0 + CKPT_STEPS, s))
        before = [ckpts[:, c0]]  # the state entering each step of the chunk
        for t in steps[:-1]:
            before.append(w[:, t, :, :, None] * before[-1]
                          + kf[:, t, :, :, None] * vf[:, t, :, None, :])
        for t, sp in zip(reversed(steps), reversed(before)):
            rt, kt, vt, yt = rf[:, t], kf[:, t], vf[:, t], dy[:, t]
            g = (yt * vt).sum(-1, keepdim=True)
            bb = (rt * u * kt).sum(-1, keepdim=True)
            dr[:, t] = torch.einsum("bhij,bhj->bhi", sp, yt) + u * kt * g
            dk[:, t] = torch.einsum("bhij,bhj->bhi", ds, vt) + rt * u * g
            dv[:, t] = torch.einsum("bhij,bhi->bhj", ds, kt) + yt * bb
            dw[:, t] = (ds * sp).sum(-1)
            du += rt * kt * g
            ds = w[:, t, :, :, None] * ds + rt[..., None] * yt[..., None, :]
    return dr, dk, dv, dw, du.sum(0), ds


class WKV6(torch.autograd.Function):
    """:func:`wkv6` under autograd: the forward keeps the state at every
    :data:`CKPT_STEPS`-th step; the backward is :func:`wkv6_bwd` from them,
    each gradient in its input's dtype."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.set_materialize_grads(False)
        if _launch.runs_plain("wkv6", r):
            y, st, ck = wkv6_plain(r, k, v, w, u, state, checkpoints=True)
        else:
            y, st, ck = _kernel(r, k, v, w, u, state, checkpoints=True)
        ctx.save_for_backward(r, k, v, w, u, ck)
        return y, st

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, w, u, ck = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        dr, dk, dv, dw, du, d0 = wkv6_bwd(r, k, v, w, u, ck, dy.contiguous(),
                                          None if ds is None else ds.contiguous())
        return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du, d0


def wkv6(r, k, v, w, u, state):
    """The recurrence over all S steps of ``r``, ``k``, ``v``, ``w`` from
    ``state``: returns ``(y, final state)``, both new f32 tensors.  One
    kernel launch for CUDA tensors; the plain version for CPU tensors.
    Under autograd (grad enabled and an input that requires it) through
    :class:`WKV6`."""
    check_inputs(r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (r, k, v, w, u, state)):
        return WKV6.apply(r, k, v, w, u, state)
    if _launch.runs_plain("wkv6", r):
        return wkv6_plain(r, k, v, w, u, state)
    return _kernel(r, k, v, w, u, state)


def _kernel(r, k, v, w, u, state, *, checkpoints: bool = False):
    """One launch of the CUDA kernel: y and the state in new tensors (and,
    with ``checkpoints``, the states it keeps)."""
    global launches
    b, s, h, kk = r.shape
    y = torch.empty((b, s, h, kk), dtype=torch.float32, device=r.device)
    s_out = torch.empty_like(state)
    ck = torch.empty((b, checkpoint_count(s), h, kk, kk), dtype=torch.float32,
                     device=r.device) if checkpoints else None
    _launch.launch("wkv6", _LIB.fn("wkv6_fwd"), r.device, r.data_ptr(), k.data_ptr(),
                   v.data_ptr(), w.data_ptr(), u.data_ptr(), state.data_ptr(),
                   y.data_ptr(), s_out.data_ptr(), None if ck is None else ck.data_ptr(),
                   b, s, h, kk, CKPT_STEPS, _DTYPES[r.dtype],
                   detail=f"r {tuple(r.shape)} {r.dtype}")
    launches += 1
    return (y, s_out, ck) if checkpoints else (y, s_out)


def wkv6_bwd(r, k, v, w, u, ckpts, dy, ds=None):
    """The gradients of :func:`wkv6` from the forward's inputs, its
    checkpoints, dy (f32) and the final state's gradient ``ds`` (None:
    zero): ``(dr, dk, dv, dw, du, d(state0))``, f32, du (H, K) summed over
    the batch.  One launch of the ``wkv6_bwd`` kernel for CUDA tensors;
    :func:`wkv6_backward_plain` for CPU tensors."""
    check_grad_inputs(r, k, v, w, u, ckpts, dy, ds)
    if _launch.runs_plain("wkv6_bwd", r):
        return wkv6_backward_plain(r, k, v, w, u, ckpts, dy, ds)
    return _kernel_bwd(r, k, v, w, u, ckpts, dy, ds)


def _kernel_bwd(r, k, v, w, u, ckpts, dy, ds):
    """One launch of the backward kernel; du summed over b in row order."""
    global bwd_launches
    b, s, h, kk = r.shape
    dr, dk, dv, dw = (torch.empty((b, s, h, kk), dtype=torch.float32, device=r.device)
                      for _ in range(4))
    du = torch.empty((b, h, kk), dtype=torch.float32, device=r.device)
    d0 = torch.empty((b, h, kk, kk), dtype=torch.float32, device=r.device)
    _launch.launch("wkv6_bwd", _LIB.fn("wkv6_bwd"), r.device, r.data_ptr(), k.data_ptr(),
                   v.data_ptr(), w.data_ptr(), u.data_ptr(), ckpts.data_ptr(),
                   dy.data_ptr(), None if ds is None else ds.data_ptr(), dr.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
                   d0.data_ptr(), b, s, h, kk, CKPT_STEPS, _DTYPES[r.dtype],
                   detail=f"r {tuple(r.shape)} {r.dtype}")
    bwd_launches += 1
    return dr, dk, dv, dw, du.sum(0), d0


def wkv6_bytes(b: int, s: int, h: int, kk: int, itemsize: int) -> int:
    """The bytes the function must move: r, k, v (``itemsize`` each) and w
    read once, y written once (f32), the state read and written, u read.
    The same under autograd: the states kept every :data:`CKPT_STEPS` steps
    are the kernel's choice, not the function's (as in
    :func:`wkv6_bwd_bytes`)."""
    n = b * s * h * kk
    return 3 * n * itemsize + 2 * n * 4 + 2 * b * h * kk * kk * 4 + h * kk * 4


def wkv6_flops(b: int, s: int, h: int, kk: int) -> int:
    """The f32 flops the function needs: :data:`FLOPS_PER_ELEMENT` a state
    element a step and :data:`FLOPS_PER_COLUMN` a state column a step."""
    return (FLOPS_PER_ELEMENT * kk + FLOPS_PER_COLUMN) * b * s * h * kk


def wkv6_bwd_bytes(b: int, s: int, h: int, kk: int, itemsize: int) -> int:
    """The bytes the gradient must move: r, k, v (``itemsize`` each), w and
    dy read once, dr, dk, dv, dw written once (f32), the initial state and
    dS read and d(state0) written, u read and du written (the checkpoints
    are the kernel's, not the function's)."""
    n = b * s * h * kk
    return 3 * n * itemsize + 2 * n * 4 + 4 * n * 4 + 3 * b * h * kk * kk * 4 + \
        2 * h * kk * 4


def wkv6_bwd_flops(b: int, s: int, h: int, kk: int) -> int:
    """The f32 flops the gradient needs: :data:`BWD_FLOPS_PER_ELEMENT` a
    state element a step and :data:`BWD_FLOPS_PER_COLUMN` a (step, head,
    channel); not the recompute of the states."""
    return (BWD_FLOPS_PER_ELEMENT * kk + BWD_FLOPS_PER_COLUMN) * b * s * h * kk
