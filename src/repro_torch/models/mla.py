"""Multi-head Latent Attention (deepseek-v2-lite): the compressed KV cache
(``kv_lora_rank`` latents and one decoupled RoPE key a token) and the
absorbed-projection decode.

Port of ``repro.models.mla``.  :class:`MLA` holds the JAX leaves in their
layouts: ``wq`` (d, H, nope + rope), ``w_dkv`` (d, R), ``w_kr`` (d, rope),
``kv_norm`` (R,), ``w_uk`` (R, H, nope), ``w_uv`` (R, H, v), ``wo``
(H, v, d).  The cache stores ``c_kv`` (B, T, R) and ``k_rope`` (B, T, rope)
only: 576 numbers a token and layer at the config's widths, where
decompressed keys and values would take 16·(192 + 128).

Two forms of the same attention:

* the **latent form** (:func:`apply_mla_latent`, plain torch) is the
  reference's, term for term: scores in the R-dim latent (q_nope absorbed
  into ``w_uk``), scale 1/sqrt(nope + rope), P·c_kv then ``w_uv``; for
  S·T > 2048² its chunked branch, MQA at dq = R + rope, dv = R on
  :func:`repro_torch.models.layers._sdpa_chunked`, q pre-scaled by
  sqrt(dq / (nope + rope)).  Decode (:func:`apply_mla_decode`) is this form
  over the cache, as in the reference, which never reached a kernel;
* the **decompressed form** (:func:`apply_mla`, prefill and training)
  runs on the flash-attention kernel: q = [q_nope ; rope(q_rope)], k =
  [c_kv·W_uk ; k_rope on every head], v = c_kv·W_uv zero-padded to
  q's width and cut back after the kernel, a 16-head MHA at D = 192 whose
  scale 1/sqrt(D) is the reference's.  In exact arithmetic q_lat·c_kv =
  q_nope·(c_kv·W_uk) and (P·c_kv)·W_uv = P·(c_kv·W_uv); the two forms
  differ by rounding only, and the decompressed one needs about half the
  operations at a 2048 prefill.

On a mesh (:class:`repro_torch.models.layers.TP`) ``wq``, ``w_uk``,
``w_uv`` and ``wo`` are cut by heads over the model axes; ``w_dkv``,
``w_kr`` and ``kv_norm`` are whole there (the reference's ``kv_lora``
rule), so every rank computes c_kv and k_rope, and their gradients, a
share of its heads on each rank, are summed over the model axes
(``copy_to``); ``wo`` is row-parallel, followed by ``reduce_from``.  The
cache is cut over the data axes only.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import collectives as C
from repro_torch.kernels.attention import flash_attention, flash_attention_plain
from repro_torch.models import common as cm
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MLADims:
    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_base: float = 10000.0


class MLA(nn.Module):
    """``init_mla``: the reference's leaves and layouts."""

    #: each parameter's logical axes (``init_mla``)
    AXES = {"wq": ("embed", "heads", "head_dim"), "w_dkv": ("embed", "kv_lora"),
            "w_kr": ("embed", "head_dim"), "kv_norm": ("kv_lora",),
            "w_uk": ("kv_lora", "heads", "head_dim"),
            "w_uv": ("kv_lora", "heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}

    def __init__(self, ini, m: MLADims):
        super().__init__()
        qd = m.qk_nope_dim + m.qk_rope_dim
        self.wq = ini.param((m.d_model, m.n_heads, qd))
        self.w_dkv = ini.param((m.d_model, m.kv_lora_rank))
        self.w_kr = ini.param((m.d_model, m.qk_rope_dim))
        self.kv_norm = ini.param((m.kv_lora_rank,), mode="ones")
        self.w_uk = ini.param((m.kv_lora_rank, m.n_heads, m.qk_nope_dim))
        self.w_uv = ini.param((m.kv_lora_rank, m.n_heads, m.v_head_dim))
        self.wo = ini.param((m.n_heads, m.v_head_dim, m.d_model))


#: the weights that every rank of the model axes holds whole (``kv_lora``)
WHOLE = ("w_dkv", "w_kr", "kv_norm")


def _shared(p, tp: L.TP):
    """``p`` with the weights whole over the model axes shared there: their
    gradients, from this rank's heads only, summed over the axes."""
    if not tp.axes:
        return p
    return dict(p, **{n: C.copy_to(p[n], tp.axes) for n in WHOLE})


def _compress(p, m: MLADims, x, positions):
    """x -> (c_kv, k_rope): the only tensors the cache stores
    (``mla.py:52``; the norm's eps 1e-6, a plain weight)."""
    c_kv = cm.rms_norm(x @ p["w_dkv"], p["kv_norm"])
    k_r = x @ p["w_kr"]
    cos, sin = L.rope_cos_sin(positions, m.qk_rope_dim, m.rope_base)
    return c_kv, L.apply_rope(k_r[:, :, None, :], cos, sin)[:, :, 0, :]


def _queries(p, m: MLADims, x, positions):
    """(q_nope, rope(q_rope)), each (B, S, H, ·) (``mla.py:61``)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    cos, sin = L.rope_cos_sin(positions, m.qk_rope_dim, m.rope_base)
    return q[..., :m.qk_nope_dim], L.apply_rope(q[..., m.qk_nope_dim:], cos, sin)


def _attend(p, m: MLADims, q_lat, q_r, c_kv, k_r, mask):
    """The reference's ``_attend`` (``mla.py:72``): scores in the latent,
    f32 softmax, the weights in the cache's dtype."""
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    logits = (torch.einsum("bshr,btr->bhst", q_lat, c_kv)
              + torch.einsum("bshk,btk->bhst", q_r, k_r)).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1).to(c_kv.dtype)
    o_lat = torch.einsum("bhst,btr->bshr", w, c_kv)
    o = torch.einsum("bshr,rhv->bshv", o_lat, p["w_uv"])
    return torch.einsum("bshv,hvm->bsm", o, p["wo"])


def apply_mla_latent(p, m: MLADims, x, positions, *, tp: L.TP = L.NO_TP):
    """Prefill or training in the latent form, plain torch (``apply_mla``
    of the reference, both of its branches); returns (out, (c_kv,
    k_rope)).  The port's main path runs :func:`apply_mla`; this is the
    form it is held against."""
    p = _shared(p, tp)
    x = C.copy_to(x, tp.axes)
    c_kv, k_r = _compress(p, m, x, positions)
    q_n, q_r = _queries(p, m, x, positions)
    q_lat = torch.einsum("bshk,rhk->bshr", q_n, p["w_uk"])
    s, t = x.shape[1], c_kv.shape[1]
    if s > 1 and s * t > L.CHUNK_THRESHOLD ** 2:
        dq = m.kv_lora_rank + m.qk_rope_dim
        fix = torch.tensor(math.sqrt(dq / (m.qk_nope_dim + m.qk_rope_dim)),
                           dtype=torch.float32).to(q_lat.dtype)
        qq = torch.cat([q_lat, q_r], dim=-1) * fix
        kk = torch.cat([c_kv, k_r], dim=-1)[:, :, None, :]
        dims = L.AttnDims(d_model=m.d_model, n_heads=q_lat.shape[2], n_kv_heads=1,
                          head_dim=dq)
        o_lat = L._sdpa_chunked(qq, kk, c_kv[:, :, None, :], dims, causal=True)
        o = torch.einsum("bshr,rhv->bshv", o_lat, p["w_uv"])
        out = torch.einsum("bshv,hvm->bsm", o, p["wo"])
    else:
        mask = (torch.arange(t, device=x.device)[None, :]
                <= torch.arange(s, device=x.device)[:, None])[None, None]
        out = _attend(p, m, q_lat, q_r, c_kv, k_r, mask)
    return C.reduce_from(out, tp.axes), (c_kv, k_r)


def decompress(p, m: MLADims, q_n, q_r, c_kv, k_r):
    """The flash kernel's operands of the decompressed form: q, k (B, ·,
    H, nope + rope) and v (B, T, H, v_head_dim) zero-padded to that width
    (the kernel takes one head dimension; the zero columns give zero
    output columns)."""
    dq = m.qk_nope_dim + m.qk_rope_dim
    if m.v_head_dim > dq:
        raise ValueError(f"v_head_dim {m.v_head_dim} wider than the scores' {dq}")
    h = q_n.shape[2]
    k_n = torch.einsum("btr,rhk->bthk", c_kv, p["w_uk"])
    k = torch.cat([k_n, k_r[:, :, None, :].expand(-1, -1, h, -1)], dim=-1)
    v = torch.einsum("btr,rhv->bthv", c_kv, p["w_uv"])
    return torch.cat([q_n, q_r], dim=-1), k, F.pad(v, (0, dq - m.v_head_dim))


def apply_mla(p, m: MLADims, x, positions, *, plain: bool = False,
              tp: L.TP = L.NO_TP):
    """Prefill and training: the decompressed form, its attention the
    flash-attention kernel (its plain version for CPU tensors, or
    everywhere with ``plain=True``), one launch a call, on this rank's
    heads.  Returns (out, (c_kv, k_rope)), as the reference."""
    p = _shared(p, tp)
    x = C.copy_to(x, tp.axes)
    c_kv, k_r = _compress(p, m, x, positions)
    q_n, q_r = _queries(p, m, x, positions)
    q, k, v = decompress(p, m, q_n, q_r, c_kv, k_r)
    attend = flash_attention_plain if plain else flash_attention
    o = attend(q, k, v, causal=True)[..., :m.v_head_dim]
    out = torch.einsum("bshv,hvm->bsm", o, p["wo"])
    return C.reduce_from(out, tp.axes), (c_kv, k_r)


def apply_mla_decode(p, m: MLADims, x, cache_ckv, cache_kr, cache_len: int,
                     positions, *, tp: L.TP = L.NO_TP):
    """One-token decode over the compressed cache (``mla.py:113``), the
    latent form: the new c_kv and k_rope are written into ``cache_ckv``
    (B, T_max, R) and ``cache_kr`` (B, T_max, rope) at ``cache_len`` in
    place (JAX returns updated copies); returns the layer's output."""
    t = cache_ckv.shape[1]
    if not 0 <= cache_len < t:
        raise ValueError(f"cache position {cache_len} outside its {t} slots")
    p = _shared(p, tp)
    x = C.copy_to(x, tp.axes)
    c_new, kr_new = _compress(p, m, x, positions)
    cache_ckv[:, cache_len:cache_len + 1] = c_new.to(cache_ckv.dtype)
    cache_kr[:, cache_len:cache_len + 1] = kr_new.to(cache_kr.dtype)
    q_n, q_r = _queries(p, m, x, positions)
    q_lat = torch.einsum("bshk,rhk->bshr", q_n, p["w_uk"])
    mask = (torch.arange(t, device=x.device) <= cache_len)[None, None, None]
    out = _attend(p, m, q_lat, q_r, cache_ckv, cache_kr, mask)
    return C.reduce_from(out, tp.axes)
