"""Attention (GQA/MQA), RoPE and MLP layers of the port: the prefill and
decode paths of the dense decoder.

Port of ``repro.models.layers``.  Layers that hold weights are
``nn.Module``s (:class:`MLP`, :class:`Attention`) with the JAX package's
parameter names and layouts (``wq`` (d, H, Dh), ``wo`` (H, Dh, d), ...);
the ``apply_*`` functions take a dict of (cast) tensors, as the JAX
functions take a pytree.  The self-attention of prefill and training runs
on the hand-written flash-attention kernel
(:func:`repro_torch.kernels.attention.flash_attention`, whose backward is
the direct attention's gradient); the one-token decode attention stays
plain PyTorch (:func:`_sdpa_direct`), as it never reached a Pallas kernel
in JAX.

On a mesh the layers run tensor-parallel where the model axes cut their
weights (:class:`TP`, chosen by :mod:`repro_torch.models.transformer` from
the specs): column-parallel ``wq``/``wk``/``wv``/``wi_*`` behind
:func:`~repro_torch.distributed.collectives.copy_to`, row-parallel
``attn.wo``/``ff.wo`` followed by
:func:`~repro_torch.distributed.collectives.reduce_from`, where GSPMD
places the same collectives in the reference.  A decode cache whose
head_dim the model axes cut (kv heads that do not divide) takes partial
q·k scores, all-reduced before the softmax, and gathers the output's
head_dim before ``wo``.  :func:`decode_attention_seqsharded` is the
sequence-sharded decode's log-sum-exp combine over a cache whose time
axis the data axes cut.

Not ported here: ``apply_cross_attention`` (Whisper), ROADMAP Queue 1
item 11.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import collectives as C
from repro_torch.kernels.attention import flash_attention, flash_attention_plain


@dataclasses.dataclass(frozen=True)
class TP:
    """How the model axes cut one layer on a mesh.  ``axes``: the model
    axes of the column- and row-parallel collectives, ``()`` where the
    layer's weights are whole on every rank (it then runs replicated).
    Attention only: ``kv``, the kv heads the local query heads read among
    those computed here (None: all of them, in order; a slice; or one
    index a query head, the groups then of one head); ``cache_dim``, the
    decode cache's dim the model axes cut (3: kv heads, 4: head_dim; None:
    whole), with ``cache_axes`` and ``cache_block`` (start, stop) of it."""
    axes: tuple = ()
    kv: object = None
    cache_dim: int | None = None
    cache_axes: tuple = ()
    cache_block: tuple | None = None


NO_TP = TP()

# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_cos_sin(positions, head_dim: int, base: float = 10000.0):
    """positions: (..., S) int -> cos/sin (..., S, head_dim/2) f32."""
    half = head_dim // 2
    inv = 1.0 / (base ** (torch.arange(half, dtype=torch.float32,
                                       device=positions.device) / half))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, half) or (S, half).  The halves
    are split at D/2 (HF llama style), computed in f32, cast back."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    x1f, x2f = x1.float(), x2.float()
    o1 = x1f * c - x2f * s
    o2 = x2f * c + x1f * s
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """``init_mlp``: gated (swiglu, geglu) or plain gelu with biases."""

    #: each parameter's logical axes (``init_mlp``)
    AXES = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"),
            "wi": ("embed", "mlp"), "bi": ("mlp",), "bo": ("embed",),
            "wo": ("mlp", "embed")}

    def __init__(self, ini, d_model: int, d_ff: int, mlp_type: str):
        super().__init__()
        if mlp_type in ("swiglu", "geglu"):
            self.wi_gate = ini.param((d_model, d_ff))
            self.wi_up = ini.param((d_model, d_ff))
        else:  # plain gelu (whisper)
            self.wi = ini.param((d_model, d_ff))
            self.bi = ini.param((d_ff,), mode="zeros")
            self.bo = ini.param((d_model,), mode="zeros")
        self.wo = ini.param((d_ff, d_model))


def apply_mlp(p, x, mlp_type: str, tp: TP = NO_TP):
    """The MLP; with ``tp.axes`` its mlp dim is this rank's block:
    column-parallel in, row-parallel out (the bias after the sum)."""
    x = C.copy_to(x, tp.axes)
    if mlp_type == "swiglu":
        h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    elif mlp_type == "geglu":
        h = F.gelu(x @ p["wi_gate"], approximate="tanh") * (x @ p["wi_up"])
    else:
        h = F.gelu(x @ p["wi"] + p["bi"].to(x.dtype), approximate="tanh")
    out = C.reduce_from(h @ p["wo"], tp.axes)
    if "bo" in p:
        out = out + p["bo"].to(x.dtype)
    return out


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_base: float = 10000.0
    causal: bool = True


class Attention(nn.Module):
    """``init_attention``: the JAX layouts, so the einsums match term for
    term."""

    #: each parameter's logical axes (``init_attention``)
    AXES = {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed"),
            "bq": ("heads", "head_dim"), "bk": ("kv_heads", "head_dim"),
            "bv": ("kv_heads", "head_dim")}

    def __init__(self, ini, a: AttnDims):
        super().__init__()
        self.wq = ini.param((a.d_model, a.n_heads, a.head_dim))
        self.wk = ini.param((a.d_model, a.n_kv_heads, a.head_dim))
        self.wv = ini.param((a.d_model, a.n_kv_heads, a.head_dim))
        self.wo = ini.param((a.n_heads, a.head_dim, a.d_model))
        if a.qkv_bias:
            self.bq = ini.param((a.n_heads, a.head_dim), mode="zeros")
            self.bk = ini.param((a.n_kv_heads, a.head_dim), mode="zeros")
            self.bv = ini.param((a.n_kv_heads, a.head_dim), mode="zeros")


def _qkv(p, a: AttnDims, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if a.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if positions is not None:
        cos, sin = rope_cos_sin(positions, a.head_dim, a.rope_base)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _sdpa_direct(q, k, v, a: AttnDims, mask=None):
    """q: (B,S,H,D)  k/v: (B,T,Hkv,D); grouped heads (head h reads kv head
    h // g); f32 softmax, weights cast to v's dtype before P·V."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, d)
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k).float()
    logits = logits / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    if mask is not None:  # a Python fill value: no host-to-device copy
        logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", w.to(v.dtype), v)
    return out.reshape(b, s, h, d)


Q_CHUNK = 512
K_CHUNK = 1024
#: S·T above which the reference's plain attention takes its chunked path
CHUNK_THRESHOLD = 2048


def _sdpa_chunked(q, k, v, a: AttnDims, causal: bool,
                  q_chunk: int = Q_CHUNK, k_chunk: int = K_CHUNK):
    """Online softmax over KV blocks, never the whole (S, T) score matrix;
    causal blocks strictly above the diagonal are skipped.  JAX's plain
    attention for S·T > 2048²; the port's prefill runs the flash kernel
    in its place, so only the parity tests call this."""
    b, s, h, d = q.shape
    t = k.shape[1]
    hkv = k.shape[2]
    g = h // hkv
    qc = min(q_chunk, s)
    while s % qc:
        qc //= 2
    kc = min(k_chunk, t)
    while t % kc:
        kc //= 2
    nq, nk = s // qc, t // kc
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    qg = q.reshape(b, nq, qc, hkv, g, d)
    kb = k.reshape(b, nk, kc, hkv, d)
    dv = v.shape[-1]
    vb = v.reshape(b, nk, kc, hkv, dv)
    dev = q.device
    outs = []
    for qi in range(nq):
        qblk = qg[:, qi]                                     # (b,qc,hkv,g,d)
        m = torch.full((b, hkv, g, qc), -1e30, dtype=torch.float32, device=dev)
        den = torch.zeros((b, hkv, g, qc), dtype=torch.float32, device=dev)
        o = torch.zeros((b, hkv, g, qc, dv), dtype=torch.float32, device=dev)
        hi = min(((qi + 1) * qc + kc - 1) // kc, nk) if causal else nk
        for ki in range(hi):
            lg = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kb[:, ki]).float() * scale
            if causal:
                qpos = qi * qc + torch.arange(qc, device=dev)
                kpos = ki * kc + torch.arange(kc, device=dev)
                lg = lg.masked_fill(kpos[None, :] > qpos[:, None], -1e30)
            m2 = torch.maximum(m, lg.amax(-1))
            alpha = torch.exp(m - m2)
            w = torch.exp(lg - m2[..., None])
            den = den * alpha + w.sum(-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", w, vb[:, ki].float())
            m = m2
        outs.append(o / torch.clamp(den[..., None], min=1e-30))  # (b,hkv,g,qc,dv)
    out = torch.stack(outs, dim=3)                           # (b,hkv,g,nq,qc,dv)
    out = out.permute(0, 3, 4, 1, 2, 5).reshape(b, s, h, dv)
    return out.to(q.dtype)


def _read_kv(k, kv):
    """The kv heads (dim 2) the local query heads read (:class:`TP`)."""
    if kv is None:
        return k
    if isinstance(kv, slice):
        return k[:, :, kv]
    return k.index_select(2, torch.tensor(kv, device=k.device))


def apply_attention(p, a: AttnDims, x, positions, *, plain: bool = False,
                    tp: TP = NO_TP):
    """Full self-attention for prefill and training; returns (out, (k, v)),
    k and v as computed here (all kv heads, or this rank's block of them).
    The attention itself is the flash-attention kernel (its plain version
    for CPU tensors, or everywhere with ``plain=True``), on this rank's
    query heads and rows."""
    if tp.axes and tp.kv is not None:
        # kv weights whole on every rank, each rank's query heads reading
        # some of their heads: their gradients are summed over the ranks
        p = dict(p, **{n: C.copy_to(p[n], tp.axes) for n in ("wk", "wv", "bk", "bv")
                       if n in p})
    q, k, v = _qkv(p, a, C.copy_to(x, tp.axes), positions)
    attend = flash_attention_plain if plain else flash_attention
    o = attend(q, _read_kv(k, tp.kv), _read_kv(v, tp.kv), causal=a.causal)
    return C.reduce_from(torch.einsum("bshd,hdm->bsm", o, p["wo"]), tp.axes), (k, v)


def cache_entry(k, tp: TP):
    """The part of a computed k (or v) that this rank's cache holds."""
    if tp.cache_dim != 4:  # whole, or kv heads already this rank's block
        return k
    lo, hi = tp.cache_block
    return k[..., lo:hi]


def _sdpa_head_dim_cut(q, k, v, axes, mask, d_full: int):
    """:func:`_sdpa_direct` over a cache whose head_dim the ranks of
    ``axes`` cut: q, k, v hold this rank's block of it (all heads); the
    scores are partial sums, all-reduced (f32) before the softmax; the
    output's head_dim is gathered."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, d).float()
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k.float())
    logits = C.all_reduce(logits, axes, "sum")
    logits = logits / torch.sqrt(torch.tensor(float(d_full), dtype=torch.float32))
    logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", w.to(v.dtype), v)
    return C.all_gather(out.reshape(b, s, h, d), axes, dim=-1)


def apply_attention_decode(p, a: AttnDims, x, cache_k, cache_v, cache_len: int,
                           positions, tp: TP = NO_TP):
    """One-token decode against a (B, T_max, Hkv, D) cache (this rank's
    part of it on a mesh, :func:`cache_entry`).  The new k and v entries
    are written into ``cache_k``/``cache_v`` at ``cache_len`` in place (JAX
    returns updated copies); returns the layer's output."""
    q, k, v = _qkv(p, a, C.copy_to(x, tp.axes), positions)  # s == 1
    t = cache_k.shape[1]
    if not 0 <= cache_len < t:
        raise ValueError(f"cache position {cache_len} outside its {t} slots")
    cache_k[:, cache_len:cache_len + 1] = cache_entry(k, tp).to(cache_k.dtype)
    cache_v[:, cache_len:cache_len + 1] = cache_entry(v, tp).to(cache_v.dtype)
    return decode_attend(p, a, q, cache_k, cache_v, cache_len, tp)


def decode_attend(p, a: AttnDims, q, ck, cv, cache_len: int, tp: TP = NO_TP):
    """One query token q (B, 1, H, D) over the caches ``ck``, ``cv`` (B, T,
    Hkv, D; this rank's part on a mesh), their entries up to
    ``cache_len`` valid, then ``wo`` (row-parallel over ``tp.axes``)."""
    t = ck.shape[1]
    valid = (torch.arange(t, device=q.device)[None, :] <= cache_len)[None, None, None]
    if tp.cache_dim == 4 and not tp.axes:
        lo, hi = tp.cache_block
        o = _sdpa_head_dim_cut(q[..., lo:hi], ck, cv, tp.cache_axes, valid, a.head_dim)
    else:
        if tp.cache_dim == 4:  # query heads cut too: the whole head_dim here
            ck, cv = (C.all_gather(c[:, :cache_len + 1], tp.cache_axes, dim=-1)
                      for c in (ck, cv))
            valid = valid[..., :cache_len + 1]
        o = _sdpa_direct(q, _read_kv(ck, tp.kv), _read_kv(cv, tp.kv), a, mask=valid)
    return C.reduce_from(torch.einsum("bshd,hdm->bsm", o, p["wo"]), tp.axes)


def decode_attention_seqsharded(q, k_shard, v_shard, local_valid, axes, *,
                                cut_axes=(), d_full: int | None = None):
    """Flash-decoding across mesh ``axes``: the cache's time axis cut over
    them, the slabs' softmaxes combined by log-sum-exp
    (``repro/models/layers.py:259``).

    q: (B, 1, H, D), the same on every rank of ``axes``; ``k_shard``,
    ``v_shard``: (B, T_loc, Hkv, D), this rank's slab; ``local_valid``:
    (B, T_loc) bool.  f32 logits, ``-1e30`` where not valid, the global
    max all-reduced over ``axes``, then each slab's sum of weights ``l``
    and weighted values ``o`` (f32) summed over them in one exchange.
    ``cut_axes``: mesh axes that cut D (q, k and v hold this rank's block
    of it): the scores are partial sums, all-reduced over them (f32)
    before the mask, and scaled by 1/sqrt(``d_full``); the output is this
    rank's block of D."""
    b, s, h, d = q.shape
    hkv = k_shard.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, d)
    if cut_axes:
        qg, k_shard = qg.float(), k_shard.float()
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k_shard).float()
    if cut_axes:
        logits = C.all_reduce(logits, cut_axes, "sum")
    logits = logits / torch.sqrt(torch.tensor(float(d_full or d), dtype=torch.float32))
    logits = logits.masked_fill(~local_valid[:, None, None, None, :], -1e30)
    m = C.all_reduce(logits.amax(-1), axes, "max")                    # (b,hkv,g,s)
    w = torch.exp(logits - m[..., None])
    l_loc = w.sum(-1)
    o_loc = torch.einsum("bhgst,bthd->bshgd", w.to(v_shard.dtype), v_shard)
    l_glob, o_glob = C.all_reduce_packed([l_loc, o_loc.float()], axes, "sum")
    lg = l_glob.permute(0, 3, 1, 2)[..., None]                        # (b,s,hkv,g,1)
    out = (o_glob / torch.clamp(lg, min=1e-30)).to(q.dtype)
    return out.reshape(b, s, h, d)
