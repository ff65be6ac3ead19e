"""Mamba's selective scan (S6) and its gradient as hand-written CUDA
kernels for Hopper.

They replace no Pallas kernel: the reference runs the recurrence as a
``lax.scan`` (``repro/models/mamba.py:102`` is the step, ``:113``
``chunked_time_scan`` runs it over the prompt, ``:123`` ``mamba_step`` is
the decode) and differentiates it with ``jax.grad``.  On the card a scan
on the hot path is a kernel: ``csrc/selective_scan.cu`` runs all S steps
of a layer in one launch, the prefill at S = the prompt and a decode step
at S = 1, and its backward in one more.

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

The gradient, with e_t = exp(dt_t a) and g_t the gradient reaching the
state h_t (h_{-1} = h0), walked from the last step with g's share from
past the end the final state's gradient dS::

    g_t     = dy_t C_t + e_{t+1} g_{t+1}
    dC_t    = sum_d dy_t h_t
    dB_t    = sum_d g_t dt_t x_t
    d(dt_t) = sum_s g_t (a e_t h_{t-1} + x_t B_t)
    dx_t    = dt_t sum_s g_t B_t + dy_t D
    dA_log  = a sum_{b,t} g_t dt_t e_t h_{t-1}
    dD      = sum_{b,t} dy_t x_t
    dh0     = e_0 g_0

:func:`selective_scan` launches the kernel for CUDA tensors, or raises;
for tensors that lie on the CPU it runs the plain version,
:func:`selective_scan_plain`, the reference's step loop in f32 torch ops
(``RunCfg(plain_scan=True)`` takes it on any device, to compare the two;
torch then differentiates its loop).  Under autograd (grad enabled and an
input that requires it) it goes through :class:`SelectiveScan`: the
forward also keeps the state at every :data:`CKPT_STEPS`-th step (the
kernel's form of the reference's chunked remat of the time scan), and the
backward is :func:`selective_scan_bwd`, the ``selective_scan_bwd`` kernel
on the card and :func:`selective_scan_backward_plain` (the same dataflow
in torch ops) on the CPU.  ``launches`` and ``bwd_launches`` count kernel
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

#: the state sizes the kernel is instantiated for (jamba's SMOKE config,
#: jamba-1.5-large)
STATE_SIZES = (8, 16)
#: the C entry point's codes of x's dtype
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: steps between two checkpoints of the state under autograd (``CKPT`` in
#: ``csrc/selective_scan.cu``): (B, ceil(S / 16), d_inner, d_state) f32,
#: 268 MB a layer at B=8, S=512, d_inner 16384, d_state 16
CKPT_STEPS = 16
#: channels a block of the backward (``BCH``): dB and dC leave the kernel
#: as one partial sum a block of channels, (B, S, ceil(d_inner / 64),
#: d_state), summed here
BWD_CHANNELS = 64
#: f32 flops a state element a step: dt·a 1, (dt·x)·B 1, exp(·)·h + that 2,
#: h·C summed 2
FLOPS_PER_ELEMENT = 6
#: f32 flops a (step, channel): dt·x 1, x·D added 2
FLOPS_PER_CHANNEL = 3
#: the backward's f32 flops a state element a step: dt·a 1, g 2, its decay
#: 1, dC's and dB's terms summed 2 each, g·B summed 2, g·e·h 2, dA's sum 2,
#: d(dt)'s 2 (not the recompute of the states)
BWD_FLOPS_PER_ELEMENT = 16
#: the backward's f32 flops a (step, channel): dt·x 1, d(dt) 2, dx 3, dD 2
BWD_FLOPS_PER_CHANNEL = 8
#: the kernel's most rows (the grid's y)
MAX_ROWS = 65535

_LIB = _launch.Library("selective_scan", {
    "selective_scan_fwd": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "selective_scan_bwd": [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [ctypes.c_void_p]})


def _dims(dt, a_log) -> tuple:
    """(B, S, d_inner, d_state) of the inputs."""
    if dt.ndim != 3 or min(dt.shape) < 1:
        raise ValueError(f"dt must be (B, S, d_inner) with sizes >= 1, got {tuple(dt.shape)}")
    return tuple(dt.shape) + (a_log.shape[-1],)


def _check(dt, x, b, c, a_log, d, f32: dict) -> None:
    """dt, x, B, C, A_log and D as the kernels take them, and ``f32``
    ({name: (tensor, shape)}) float32 tensors of those shapes, on dt's
    device."""
    rows, s, di, ds = _dims(dt, a_log)
    want = {"x": (x, (rows, s, di)), "B": (b, (rows, s, ds)), "C": (c, (rows, s, ds)),
            "A_log": (a_log, (di, ds)), "D": (d, (di,)), **f32}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if ds not in STATE_SIZES:
        raise ValueError(f"d_state {ds}: the selective_scan kernel takes {STATE_SIZES}")
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows: the selective_scan kernel takes at most {MAX_ROWS}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"selective_scan takes float32 or bfloat16 x, got {x.dtype}")
    rest = [dt, b, c, a_log, d] + [t for t, _ in f32.values()]
    if any(t.dtype != torch.float32 for t in rest):
        raise ValueError(f"dt, B, C, A_log, D, {', '.join(f32)} must be float32, got "
                         f"{[str(t.dtype) for t in rest]}")
    if len({t.device for t in [x] + rest}) != 1:
        raise ValueError("selective_scan's inputs lie on different devices")
    _launch.check_contiguous("selective_scan", x, *rest)


def check_inputs(dt, x, b, c, a_log, d, h0) -> None:
    """Refuse shapes, dtypes, devices and layouts the kernel does not
    take."""
    rows, _, di, ds = _dims(dt, a_log)
    _check(dt, x, b, c, a_log, d, {"the state": (h0, (rows, di, ds))})


def checkpoint_count(s: int) -> int:
    """The states the forward keeps under autograd over ``s`` steps."""
    return -(-s // CKPT_STEPS)


def check_grad_inputs(dt, x, b, c, a_log, d, ckpts, dy, dh) -> None:
    """Refuse what :func:`selective_scan_bwd` does not take: the forward's
    inputs as :func:`check_inputs`, its checkpoints (B, ceil(S /
    CKPT_STEPS), d_inner, d_state), dy (B, S, d_inner) and the final
    state's gradient ``dh`` (B, d_inner, d_state) or None, all f32 and
    contiguous on dt's device."""
    rows, s, di, ds = _dims(dt, a_log)
    f32 = {"the checkpoints": (ckpts, (rows, checkpoint_count(s), di, ds)),
           "dy": (dy, (rows, s, di))}
    if dh is not None:
        f32["dS"] = (dh, (rows, di, ds))
    _check(dt, x, b, c, a_log, d, f32)


def _step(h, dt, a, dtx, b, t):
    """The state after step ``t`` from the state ``h`` before it (the
    reference's step, ``mamba.py:103–104``)."""
    return torch.exp(dt[:, t, :, None] * a) * h + dtx[:, t, :, None] * b[:, t, None, :]


def selective_scan_plain(dt, x, b, c, a_log, d, h0, *, checkpoints: bool = False):
    """The plain PyTorch version: the reference's step loop
    (``mamba.py:102–109``) in f32, one step at a time; torch differentiates
    it under autograd.  With ``checkpoints`` it also returns the state
    entering every :data:`CKPT_STEPS`-th step, (B, ceil(S / CKPT_STEPS),
    d_inner, d_state), as the kernel keeps them.  On the card its products
    go through cuBLAS: keep TF32 off."""
    global plain_calls
    plain_calls += 1
    check_inputs(dt, x, b, c, a_log, d, h0)
    a = -torch.exp(a_log)
    xf = x.float()
    dtx = dt * xf
    h = h0
    ys, kept = [], []
    for t in range(dt.shape[1]):
        if checkpoints and t % CKPT_STEPS == 0:
            kept.append(h)
        h = _step(h, dt, a, dtx, b, t)
        ys.append(torch.matmul(h, c[:, t, :, None])[..., 0])
    y = torch.stack(ys, 1) + xf * d
    return (y, h, torch.stack(kept, 1)) if checkpoints else (y, h)


def _block_sums(terms):
    """(B, n, d_inner, k) terms summed over each block of
    :data:`BWD_CHANNELS` channels, as the kernel's blocks sum them: (B, n,
    ceil(d_inner / BWD_CHANNELS), k)."""
    rows, n, di, k = terms.shape
    blocks = -(-di // BWD_CHANNELS)
    pad = torch.zeros((rows, n, blocks * BWD_CHANNELS - di, k), dtype=terms.dtype,
                      device=terms.device)
    return torch.cat([terms, pad], 2).view(rows, n, blocks, BWD_CHANNELS, k).sum(3)


def selective_scan_backward_plain(dt, x, b, c, a_log, d, ckpts, dy, dh=None):
    """The plain version of :func:`selective_scan_bwd`, in f32 torch ops,
    with the kernel's dataflow: the chunks of :data:`CKPT_STEPS` steps from
    the last, each chunk's states recomputed from its checkpoint with the
    forward's step, then its steps walked backward; dB and dC summed a
    block of :data:`BWD_CHANNELS` channels at a time, then over the
    blocks, dA_log and dD a row at a time, then over the rows."""
    global plain_bwd_calls
    plain_bwd_calls += 1
    check_grad_inputs(dt, x, b, c, a_log, d, ckpts, dy, dh)
    rows, s, di = dt.shape
    ds = a_log.shape[-1]
    dev = dt.device
    a = -torch.exp(a_log)
    xf = x.float()
    dtx = dt * xf
    g = torch.zeros((rows, di, ds), dtype=torch.float32, device=dev) if dh is None \
        else dh.clone()
    ddt, dx = (torch.empty((rows, s, di), dtype=torch.float32, device=dev) for _ in range(2))
    blocks = -(-di // BWD_CHANNELS)
    db, dc = (torch.empty((rows, s, blocks, ds), dtype=torch.float32, device=dev)
              for _ in range(2))
    da = torch.zeros((rows, di, ds), dtype=torch.float32, device=dev)
    for c0 in reversed(range(checkpoint_count(s))):
        t0 = c0 * CKPT_STEPS
        steps = range(t0, min(t0 + CKPT_STEPS, s))
        before = [ckpts[:, c0]]  # the state entering each step of the chunk
        for t in steps[:-1]:
            before.append(_step(before[-1], dt, a, dtx, b, t))
        terms = []  # each step's (B, d_inner, 2, d_state) terms of dB and dC
        for t, hp in zip(reversed(steps), reversed(before)):
            e = torch.exp(dt[:, t, :, None] * a)
            hc = e * hp + dtx[:, t, :, None] * b[:, t, None, :]
            gs = dy[:, t, :, None] * c[:, t, None, :] + g
            terms.append(torch.stack([gs * dtx[:, t, :, None], dy[:, t, :, None] * hc], 2))
            gb = (gs * b[:, t, None, :]).sum(-1)
            w = gs * (e * hp)
            da += w * dt[:, t, :, None]
            ddt[:, t] = (w * a).sum(-1) + xf[:, t] * gb
            dx[:, t] = dt[:, t] * gb + dy[:, t] * d
            g = gs * e
        # the chunk's sums a block of channels, as the kernel's blocks leave them
        sums = _block_sums(torch.stack(terms[::-1], 1).flatten(3))
        db[:, t0:t0 + len(steps)], dc[:, t0:t0 + len(steps)] = sums[..., :ds], sums[..., ds:]
    return (ddt, dx, db.sum(2), dc.sum(2), (a * da).sum(0), (dy * xf).sum(1).sum(0), g)


class SelectiveScan(torch.autograd.Function):
    """:func:`selective_scan` under autograd: the forward keeps the state
    at every :data:`CKPT_STEPS`-th step; the backward is
    :func:`selective_scan_bwd` from them, each gradient in its input's
    dtype."""

    @staticmethod
    def forward(ctx, dt, x, b, c, a_log, d, h0):
        ctx.set_materialize_grads(False)
        if _launch.runs_plain("selective_scan", dt):
            y, h, ck = selective_scan_plain(dt, x, b, c, a_log, d, h0, checkpoints=True)
        else:
            y, h, ck = _kernel(dt, x, b, c, a_log, d, h0, checkpoints=True)
        ctx.save_for_backward(dt, x, b, c, a_log, d, ck)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        dt, x, b, c, a_log, d, ck = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(dt.shape, dtype=torch.float32, device=dt.device)
        ddt, dx, db, dc, da, dd, dh0 = selective_scan_bwd(
            dt, x, b, c, a_log, d, ck, dy.contiguous(),
            None if dh is None else dh.contiguous())
        return ddt, dx.to(x.dtype), db, dc, da, dd, dh0


def selective_scan(dt, x, b, c, a_log, d, h0):
    """The recurrence over all S steps from the state ``h0``: returns ``(y,
    final state)``, both new f32 tensors.  One kernel launch for CUDA
    tensors; the plain version for CPU tensors.  Under autograd (grad
    enabled and an input that requires it) through :class:`SelectiveScan`."""
    check_inputs(dt, x, b, c, a_log, d, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (dt, x, b, c, a_log, d, h0)):
        return SelectiveScan.apply(dt, x, b, c, a_log, d, h0)
    if _launch.runs_plain("selective_scan", dt):
        return selective_scan_plain(dt, x, b, c, a_log, d, h0)
    return _kernel(dt, x, b, c, a_log, d, h0)


def _kernel(dt, x, b, c, a_log, d, h0, *, checkpoints: bool = False):
    """One launch of the CUDA kernel: y and the state in new tensors (and,
    with ``checkpoints``, the states it keeps)."""
    global launches
    rows, s, di = dt.shape
    ds = a_log.shape[-1]
    y = torch.empty((rows, s, di), dtype=torch.float32, device=dt.device)
    h_out = torch.empty_like(h0)
    ck = torch.empty((rows, checkpoint_count(s), di, ds), dtype=torch.float32,
                     device=dt.device) if checkpoints else None
    _launch.launch("selective_scan", _LIB.fn("selective_scan_fwd"), dt.device,
                   dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
                   a_log.data_ptr(), d.data_ptr(), h0.data_ptr(), y.data_ptr(),
                   h_out.data_ptr(), None if ck is None else ck.data_ptr(), rows, s, di,
                   ds, CKPT_STEPS, _DTYPES[x.dtype],
                   detail=f"dt {tuple(dt.shape)}, x {x.dtype}")
    launches += 1
    return (y, h_out, ck) if checkpoints else (y, h_out)


def selective_scan_bwd(dt, x, b, c, a_log, d, ckpts, dy, dh=None):
    """The gradients of :func:`selective_scan` from the forward's inputs
    (its checkpoints hold the initial state), dy (f32) and the final
    state's gradient ``dh`` (None: zero): ``(d(dt), dx, dB, dC, dA_log, dD,
    d(h0))``, all f32, dA_log and dD summed over the batch.  One launch of
    the ``selective_scan_bwd`` kernel for CUDA tensors (and the sums over
    its partials); :func:`selective_scan_backward_plain` for CPU tensors."""
    check_grad_inputs(dt, x, b, c, a_log, d, ckpts, dy, dh)
    if _launch.runs_plain("selective_scan_bwd", dt):
        return selective_scan_backward_plain(dt, x, b, c, a_log, d, ckpts, dy, dh)
    return _kernel_bwd(dt, x, b, c, a_log, d, ckpts, dy, dh)


def _kernel_bwd(dt, x, b, c, a_log, d, ckpts, dy, dh):
    """One launch of the backward kernel, then its partial sums summed in
    order: dB and dC over the blocks of channels, dA_log and dD over the
    rows."""
    global bwd_launches
    rows, s, di = dt.shape
    ds = a_log.shape[-1]
    dev = dt.device
    ddt, dx = (torch.empty((rows, s, di), dtype=torch.float32, device=dev) for _ in range(2))
    blocks = -(-di // BWD_CHANNELS)
    db, dc = (torch.empty((rows, s, blocks, ds), dtype=torch.float32, device=dev)
              for _ in range(2))
    da = torch.empty((rows, di, ds), dtype=torch.float32, device=dev)
    dd = torch.empty((rows, di), dtype=torch.float32, device=dev)
    dh0 = torch.empty((rows, di, ds), dtype=torch.float32, device=dev)
    _launch.launch("selective_scan_bwd", _LIB.fn("selective_scan_bwd"), dev,
                   dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
                   a_log.data_ptr(), d.data_ptr(), ckpts.data_ptr(), dy.data_ptr(),
                   None if dh is None else dh.data_ptr(), ddt.data_ptr(), dx.data_ptr(),
                   db.data_ptr(), dc.data_ptr(), da.data_ptr(), dd.data_ptr(),
                   dh0.data_ptr(), rows, s, di, ds, CKPT_STEPS, BWD_CHANNELS,
                   _DTYPES[x.dtype], detail=f"dt {tuple(dt.shape)}, x {x.dtype}")
    bwd_launches += 1
    return ddt, dx, db.sum(2), dc.sum(2), da.sum(0), dd.sum(0), dh0


def selective_scan_bytes(b: int, s: int, di: int, ds: int, itemsize: int) -> int:
    """The bytes the function must move: dt (f32) and x (``itemsize``)
    read once, y written once (f32), B and C read, A_log and D read, the
    state read and written.  The same under autograd: the states kept every
    :data:`CKPT_STEPS` steps are the kernel's choice, not the function's
    (as in :func:`selective_scan_bwd_bytes`)."""
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


def selective_scan_bwd_bytes(b: int, s: int, di: int, ds: int, itemsize: int) -> int:
    """The bytes the gradient must move: dt and dy (f32) and x
    (``itemsize``) read once, d(dt) (f32) and dx (``itemsize``, x's dtype)
    written once, B and C read and dB and dC written, A_log and D read and
    their gradients written, the initial state and dS read and d(h0)
    written (the checkpoints are the kernel's, not the function's)."""
    n = b * s * di
    return n * (4 + 4 + itemsize) + n * (4 + itemsize) + 4 * b * s * ds * 4 + \
        2 * (di * ds + di) * 4 + 3 * b * di * ds * 4


def selective_scan_bwd_flops(b: int, s: int, di: int, ds: int) -> int:
    """The f32 flops the gradient needs: :data:`BWD_FLOPS_PER_ELEMENT` a
    state element a step and :data:`BWD_FLOPS_PER_CHANNEL` a (step,
    channel); not the recompute of the states, its exps apart
    (:func:`selective_scan_bwd_exps`)."""
    return (BWD_FLOPS_PER_ELEMENT * ds + BWD_FLOPS_PER_CHANNEL) * b * s * di


def selective_scan_bwd_exps(b: int, s: int, di: int, ds: int) -> int:
    """The exponentials the gradient needs: the decay e_t, one a state
    element a step (not the recompute's)."""
    return b * s * di * ds
