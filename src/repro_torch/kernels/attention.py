"""Causal or full GQA flash attention as a hand-written CUDA kernel for Hopper.

Port of ``repro.kernels.attention`` (the Pallas TPU kernel
``flash_attention``).  q is ``(B, S, H, D)``, k and v ``(B, T, Hkv, D)``
with ``H % Hkv == 0``: query head h reads kv head ``h // (H // Hkv)``.  The
scores are ``(q_f32 · k_f32ᵀ) / sqrt(D)``, masked to -1e30 above the
top-left aligned causal diagonal; an online softmax over key blocks keeps
the running max, the sum and the accumulator in f32; the output is
``acc / max(l, 1e-30)`` in q's dtype.

The kernel, ``csrc/flash_attention.cu``, reads q, k and v in this layout
through their strides.  In bf16 it is built like a Hopper GEMM: a producer
warp keeps TMA loads of K and V tiles in flight through a ring of
shared-memory stages under mbarriers, and two consumer warpgroups run both
products on ``wgmma`` (bf16 in, f32 accumulate; p split into two bf16
halves so that P·V keeps 16 bits of it).  In f32 it runs full-precision
CUDA-core FMAs.  It is built with ``nvcc`` at first use
(:mod:`repro_torch.kernels._build`) and called through ``ctypes`` on
PyTorch's current stream, without synchronising.

TMA describes a bf16 operand only when its head dimension is a multiple
of 8 and its base and strides are 16-byte aligned; :func:`tma_operands`
copies any other operand into a zero-padded contiguous buffer first.

:func:`flash_attention` launches the kernel for CUDA tensors, or raises.
For tensors that lie on the CPU it runs the plain version,
:func:`flash_attention_plain`.  Where autograd records (grad enabled and
q, k or v requiring grad) the launch goes through :class:`FlashAttention`,
an autograd Function whose backward is :func:`attention_grad`, the
gradient of the direct softmax attention in torch ops: the kernel writes
its output through ``ctypes``, so without it that output would carry no
history and q, k and v no gradient.  ``launches`` counts kernel launches,
``plain_calls`` plain-version calls and ``pad_copies`` the launches whose
operands had to be copied into padded buffers; nothing else adds to any.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch

launches = 0
plain_calls = 0
pad_copies = 0

#: masked scores (attention.py:29): finite, so a row's max stays finite
NEG_INF = -1e30
#: the kernel's largest head dimension (its tiles pad D up to 32..256)
MAX_HEAD_DIM = 256
#: TMA's alignment of an operand's base and strides, bytes
TMA_ALIGN = 16
#: the bf16 kernel's operands have a head extent in steps of 8 (16 bytes)
HEAD_STEP = 8
#: the C entry point's dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = _launch.Library("flash_attention", {"flash_attention_fwd": (
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 9
    + [ctypes.c_void_p])})


def _blocks(n: int, blk: int) -> int:
    """``attention.py:76–81``: the block is at most ``n`` and halves until
    it divides ``n``."""
    blk = min(blk, n)
    while n % blk:
        blk //= 2
    return blk


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Refuse shapes, dtypes and devices the kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q must be (B, S, H, D) and k, v (B, T, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(B={b}, T, Hkv, D={d})")
    hkv = k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv}")
    if min(b, s, k.shape[1], h, d) == 0:
        raise ValueError(f"flash_attention needs non-empty q {tuple(q.shape)} "
                         f"and k, v {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention takes float32 or bfloat16 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dimension {d} > {MAX_HEAD_DIM}")


def flash_attention_plain(q, k, v, *, causal: bool = True, blk_q: int = 256,
                          blk_k: int = 256, scale: float | None = None):
    """The plain PyTorch version, the kernel's dataflow block by block:
    for each ``blk_q`` query block, an online softmax over the ``blk_k``
    key blocks with f32 m, l and acc (``attention.py:32–62``); every query
    head of a group against its kv head, with no copy of k or v.  Blocks
    strictly above the causal diagonal are skipped (they change no bit).
    On the card its products go through cuBLAS: keep TF32 off for f32.
    ``scale`` is the scores' factor, 1/sqrt(D) by default; operands whose
    head dimension was zero-padded (:func:`tma_operands`) pass the true
    D's."""
    global plain_calls
    plain_calls += 1
    check_qkv(q, k, v)
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    bq, bk = _blocks(s, blk_q), _blocks(t, blk_k)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    # (B, Hkv, g, S, D) and (B, Hkv, 1, T, D): head h = hk·g + j
    qf = q.float().reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3).unsqueeze(2)
    vf = v.float().permute(0, 2, 1, 3).unsqueeze(2)
    out = torch.empty((b, hkv, g, s, d), dtype=torch.float32, device=q.device)
    for i in range(s // bq):
        qb = qf[..., i * bq:(i + 1) * bq, :]
        m = torch.full((b, hkv, g, bq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, bq, d), dtype=torch.float32,
                          device=q.device)
        qpos = torch.arange(i * bq, (i + 1) * bq, device=q.device)
        for j in range(t // bk):
            if causal and j * bk > (i + 1) * bq - 1:
                break
            sc = (qb @ kf[..., j * bk:(j + 1) * bk, :].transpose(-1, -2)) * scale
            if causal:
                kpos = torch.arange(j * bk, (j + 1) * bk, device=q.device)
                sc = sc.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vf[..., j * bk:(j + 1) * bk, :]
            m = m_new
        out[..., i * bq:(i + 1) * bq, :] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def tma_strides(x: torch.Tensor) -> tuple[int, int, int]:
    """Strides of x's first three dimensions as the kernel's tensor map
    takes them: a dimension of size 1 is never stepped, so its stride is
    replaced by the contiguous one."""
    st = list(x.stride()[:3])
    inner = x.shape[3]
    for i in (2, 1, 0):
        if x.shape[i] == 1:
            st[i] = inner
        inner = st[i] * x.shape[i]
    return tuple(st)


def tma_ready(x: torch.Tensor, dg: int) -> bool:
    """True when a tensor map can read x as it lies with head extent
    ``dg``: 16-byte aligned base and strides, and a head dimension of
    ``dg`` elements."""
    size = x.element_size()
    return (x.shape[3] == dg and x.data_ptr() % TMA_ALIGN == 0
            and all(st > 0 and st * size % TMA_ALIGN == 0 for st in tma_strides(x)))


def tma_operands(q, k, v):
    """q, k and v as the bf16 kernel's tensor maps can describe them, and
    their head extent ``dg``, D rounded up to a multiple of 8.  An operand
    whose head dimension is not ``dg``, or whose base or strides are not
    16-byte aligned, is copied into a zero-padded contiguous
    ``(B, rows, heads, dg)`` buffer; the rest are returned as they are.
    Returns ``(q, k, v, dg, copied)``; the zero columns add nothing to
    q·kᵀ and give zero output columns, which the kernel does not store."""
    dg = -(-q.shape[3] // HEAD_STEP) * HEAD_STEP
    out, copied = [], False
    for x in (q, k, v):
        if not tma_ready(x, dg):
            padded = x.new_zeros(x.shape[:3] + (dg,))
            padded[..., :x.shape[3]] = x
            x, copied = padded, True
        out.append(x)
    return (*out, dg, copied)


def flash_attention(q, k, v, *, causal: bool = True, blk_q: int = 256,
                    blk_k: int = 256):
    """Attention of q ``(B, S, H, D)`` over k, v ``(B, T, Hkv, D)``, out
    ``(B, S, H, D)`` in q's dtype.  ``causal`` masks ``kpos > qpos`` (the
    diagonal aligned at the top left, as the JAX kernel; meant for S == T).
    ``blk_q``/``blk_k`` block the plain version as the JAX kernel's grid;
    the CUDA kernel tiles by its own sizes (128 queries and 64 or 128 keys
    for bf16, 32 for f32).  On CUDA tensors that autograd records, the
    launch goes through :class:`FlashAttention`, so the output is attached
    to q, k and v."""
    check_qkv(q, k, v)
    if _launch.runs_plain("flash_attention", q):
        return flash_attention_plain(q, k, v, causal=causal, blk_q=blk_q,
                                     blk_k=blk_k)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return _kernel_forward(q, k, v, causal)


class FlashAttention(torch.autograd.Function):
    """The kernel's forward under autograd.  The forward is the launch of
    :func:`flash_attention` and saves q, k and v; the backward recomputes
    the scores and returns :func:`attention_grad`.  The JAX package
    differentiates its plain attention (``layers.py`` ``_sdpa_direct``), so
    this is the gradient it takes; no backward kernel exists there."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _kernel_forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*attention_grad(q, k, v, do, causal=ctx.causal), None)


def attention_grad(q, k, v, do, *, causal: bool = True):
    """Gradients of q, k and v of the direct GQA softmax attention
    ``softmax(q·kᵀ/sqrt(D)) · v`` (masked as :func:`flash_attention`) for
    the output's gradient ``do``, in f32, each cast to its input's dtype:
    with p the softmax and dp = do·vᵀ, dv = pᵀ·do, ds = p ⊙ (dp − Σ p ⊙ dp)
    over keys, dq = ds·k/sqrt(D) and dk = dsᵀ·q/sqrt(D), the query heads of
    a group summed into their kv head."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    scale = 1.0 / d ** 0.5
    qf = q.float().reshape(b, s, hkv, h // hkv, d)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(b, s, hkv, h // hkv, d)
    sc = torch.einsum("bshgd,bthd->bhgst", qf, kf) * scale
    if causal:
        pos_q = torch.arange(s, device=q.device)
        pos_k = torch.arange(k.shape[1], device=q.device)
        sc = sc.masked_fill(pos_k[None, :] > pos_q[:, None], NEG_INF)
    p = torch.softmax(sc, dim=-1)
    del sc
    dv = torch.einsum("bhgst,bshgd->bthd", p, dof)
    dp = torch.einsum("bshgd,bthd->bhgst", dof, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    del p, dp
    dq = torch.einsum("bhgst,bthd->bshgd", ds, kf) * scale
    dk = torch.einsum("bhgst,bshgd->bthd", ds, qf) * scale
    return dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_forward(q, k, v, causal: bool):
    """One launch of the CUDA kernel: the output in a new tensor."""
    global launches, pad_copies
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention needs a contiguous head dimension")
    if b * h > 65535:
        raise ValueError(f"B·H = {b * h} exceeds the grid limit of 65535")
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dg, copied = d, False
    if q.dtype == torch.bfloat16:
        q, k, v, dg, copied = tma_operands(q, k, v)
    strides = [st for x in (q, k, v) for st in tma_strides(x)]
    fn = _LIB.fn("flash_attention_fwd")
    _launch.launch("flash_attention", fn, q.device, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), o.data_ptr(), *strides, b, s, t, h, hkv, d,
                   int(causal), _DTYPES[q.dtype], dg,
                   detail=f"q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}")
    launches += 1
    pad_copies += copied
    return o


#: bf16 agreement of the kernel with its plain version (:func:`bf16_gap`):
#: each element within BF16_ULPS units in the last place of the plain
#: value plus BF16_ATOL_RMS·rms(plain), and at most BF16_MISMATCH of the
#: elements (or BF16_MISMATCH_MIN elements, if that is more) different
BF16_ULPS = 2
BF16_ATOL_RMS = 1e-3
BF16_MISMATCH = 0.02
BF16_MISMATCH_MIN = 8


def bf16_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far a bf16 output ``got`` lies from ``want``, two roundings of
    the same f32 attention that differ only in summation order.

    Their f32 values then differ by ~1e-6 relative, so the bf16 outputs
    differ only where the value lies that close to a rounding boundary: by
    one unit in the last place (2⁻⁸ relative), on a small share of the
    elements.  An allclose with one tolerance cannot see less than its
    tolerance: at S=2048 the outputs are ~0.05, as small as a 3e-2 atol.
    Returns ``worst``, the largest |got - want| over ``BF16_ULPS``·ulp(want)
    + ``BF16_ATOL_RMS``·rms(want) (the atol covers values near zero, which
    cancel in f32); ``mismatch``, the share of elements that differ; and
    ``ok``, ``worst <= 1`` and at most ``BF16_MISMATCH`` of the elements,
    or ``BF16_MISMATCH_MIN`` of them, different, on finite values (in an
    output of a hundred elements one or two flips are chance).  Rounding p
    to bf16 before P·V moves ~40% of the elements and fails both; a
    dropped key tile fails ``worst``."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ulp = torch.where(w == 0, torch.zeros_like(w),
                      torch.exp2(torch.frexp(w).exponent.float() - 8))
    atol = BF16_ATOL_RMS * w.pow(2).mean().sqrt()
    worst = (d / (BF16_ULPS * ulp + atol)).max().item()
    differ = int((d > 0).sum().item())
    mismatch = differ / d.numel()
    ok = bool(torch.isfinite(g).all()) and worst <= 1.0 \
        and differ <= max(BF16_MISMATCH * d.numel(), BF16_MISMATCH_MIN)
    return {"worst": worst, "mismatch": mismatch, "max_abs": d.max().item(),
            "ok": ok}


def bf16_control(q, k, v, *, round_p: bool = False, drop_tile: bool = False):
    """Causal GQA attention in f32 at once (no blocks), the control that
    calibrates :func:`bf16_gap`: as is, it sums in another order than the
    plain version and must pass; ``round_p`` rounds p to bf16 before P·V
    (what the kernel's hi/lo split of p avoids) and ``drop_tile`` leaves
    out keys 64..127 for the last 64 queries, and each must fail."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    sc = torch.einsum("bshgd,bthd->bhgst", q.float().reshape(b, s, hkv, h // hkv, d),
                      k.float()) / d ** 0.5
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] > pos[:, None]
    if drop_tile:
        mask[s - 64:, 64:128] = True
    sc = sc.masked_fill(mask, NEG_INF)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    l = p.sum(-1)
    if round_p:
        p = p.bfloat16().float()
    o = torch.einsum("bhgst,bthd->bhgsd", p, v.float()) / l[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def attention_flops(b: int, s: int, t: int, h: int, d: int, causal: bool) -> float:
    """Flops of the two products that the inputs need: 4·S·T·D a head, and
    under the causal mask only the kept pairs, Σ_q min(q + 1, T)."""
    pairs = (sum(min(i + 1, t) for i in range(s)) if causal else s * t)
    return 4.0 * b * h * d * pairs

