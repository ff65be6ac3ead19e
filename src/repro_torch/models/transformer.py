"""The dense uniform decoder of the port: init, full-sequence forward,
the training loss, prefill and one-token greedy decode over a KV cache.

Port of the uniform path of ``repro.models.transformer`` (smollm,
deepseek, qwen, gemma: GQA/MQA, SwiGLU/GeGLU, optional QKV bias, RoPE,
RMSNorm or RMSNorm(1 + w), optional embedding scale, tied or untied head).
Layers run as a Python loop over an ``nn.ModuleList`` where JAX scans over
layer-stacked params; each block's params are cast to the compute dtype
where JAX's ``_cast_f`` casts them, at the top of every block.  The
attention of the forward (prefill and training) is the flash-attention
kernel.  Under autograd the blocks are rematerialised as JAX's
``_scan_blocks`` does (:func:`_scan_blocks`: ``torch.utils.checkpoint``).

Configs outside this path raise ``NotImplementedError`` naming ROADMAP
Queue 1 item 11: MoE, MLA, RWKV, the Jamba hybrid, Whisper's
encoder–decoder, the VLM ``embeds`` input, the int8 KV cache
(``kv_quant``); the port runs on one device, so it has no mesh and no
sequence-sharded decode.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import layers as L

LM_ITEM = "ROADMAP Queue 1 item 11"


@dataclasses.dataclass(frozen=True)
class RunCfg:
    """Runtime context (orthogonal to the arch config).  JAX's ``mesh``,
    ``seq_shard_kv`` and axis names have no counterpart on one device.
    ``remat`` rematerialises the blocks in the backward where the config's
    ``remat`` is on too, as JAX's.  ``plain_attention`` sends the forward's
    attention through the kernel's plain version on any device; it is off
    on the main path and exists to compare the two."""
    plain_attention: bool = False
    remat: bool = True


def check_supported(cfg: ArchConfig) -> None:
    """Raise for what this slice does not run."""
    left = []
    if cfg.moe is not None:
        left.append("MoE")
    if cfg.attn_kind == "mla":
        left.append("MLA attention")
    if cfg.mixer != "attn":
        left.append(f"mixer {cfg.mixer!r}")
    if cfg.encdec:
        left.append("encoder-decoder")
    if cfg.embed_mode != "tokens":
        left.append(f"embed_mode {cfg.embed_mode!r}")
    if cfg.kv_quant:
        left.append("the int8 KV cache (kv_quant)")
    if left:
        raise NotImplementedError(
            f"{cfg.arch_id}: {', '.join(left)} not ported yet ({LM_ITEM}); the "
            "port runs the dense uniform decoder on one device")


def _dt(cfg: ArchConfig) -> torch.dtype:
    return cm.dtype_of(cfg.compute_dtype)


def _cast_f(module: nn.Module, dtype: torch.dtype | None) -> dict:
    """The module's parameters as a nested dict, floating ones cast to
    ``dtype`` (``transformer.py:53``; ``None`` keeps their dtype)."""
    tree: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.to(dtype) if dtype and p.is_floating_point() else p
    return tree


def attn_dims(cfg: ArchConfig) -> L.AttnDims:
    return L.AttnDims(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                      qkv_bias=cfg.qkv_bias, rope_base=cfg.rope_base)


# ---------------------------------------------------------------------------
# init (parameter names as the JAX params' keys)
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """``_norm_param``: RMSNorm weight (zeros for RMSNorm(1 + w)) or
    LayerNorm weight and bias."""

    def __init__(self, ini, cfg: ArchConfig):
        super().__init__()
        d = cfg.d_model
        if cfg.norm == "ln":
            self.w = ini.param((d,), mode="ones")
            self.b = ini.param((d,), mode="zeros")
        else:
            self.w = ini.param((d,), mode="zeros" if cfg.norm_plus_one else "ones")


def _apply_norm(p, x, cfg: ArchConfig):
    if cfg.norm == "ln":
        return cm.layer_norm(x, p["w"], p["b"])
    return cm.rms_norm(x, p["w"], plus_one=cfg.norm_plus_one)


class Block(nn.Module):
    """``_init_uniform_block`` without MLA or MoE."""

    def __init__(self, ini, cfg: ArchConfig):
        super().__init__()
        self.ln1 = Norm(ini, cfg)
        self.ln2 = Norm(ini, cfg)
        self.attn = L.Attention(ini, attn_dims(cfg))
        self.ff = L.MLP(ini, cfg.d_model, cfg.d_ff, cfg.mlp_type)


class Transformer(nn.Module):
    """``init_model``'s uniform branch: ``embed`` (vocab, d), ``final_norm``,
    ``head`` (d, vocab) unless tied, and ``blocks`` (one :class:`Block` a
    layer where JAX stacks them on a leading axis)."""

    def __init__(self, cfg: ArchConfig, ini):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        d = cfg.d_model
        self.embed = ini.param((cfg.vocab, d), scale=1.0 / d ** 0.5)
        self.final_norm = Norm(ini, cfg)
        if not cfg.tie_embeddings:
            self.head = ini.param((d, cfg.vocab))
        self.blocks = nn.ModuleList(Block(ini, cfg) for _ in range(cfg.n_layers))


def init_model(cfg: ArchConfig, seed: int = 0, device="cuda") -> Transformer:
    """Random parameters from ``seed`` on ``device`` (``"meta"`` for shapes
    only), in ``cfg.param_dtype``."""
    dev = torch.device(device)
    gen = None if dev.type == "meta" else torch.Generator(
        device=resolve_device(dev)).manual_seed(seed)
    return Transformer(cfg, cm.Initializer(gen, cm.dtype_of(cfg.param_dtype), dev))


# ---------------------------------------------------------------------------
# forward (prefill) and decode
# ---------------------------------------------------------------------------


def _uniform_block_fwd(p, cfg: ArchConfig, run: RunCfg, x, positions):
    h = _apply_norm(p["ln1"], x, cfg)
    a, kv = L.apply_attention(p["attn"], attn_dims(cfg), h, positions,
                              plain=run.plain_attention)
    x = x + a
    h = _apply_norm(p["ln2"], x, cfg)
    x = x + L.apply_mlp(p["ff"], h, cfg.mlp_type)
    return x, kv


def _embed_tokens(params: Transformer, cfg: ArchConfig, tokens):
    cd = _dt(cfg)
    x = params.embed[tokens.long()].to(cd)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cd)
    return x


def _head_out(params: Transformer, cfg: ArchConfig, x):
    """Logits in the compute dtype, as JAX (its f32 upcast is in the loss)."""
    w = params.embed.T if cfg.tie_embeddings else params.head
    return x @ w.to(x.dtype)


def _remat_group(n: int, target: int = 8) -> int:
    """The largest divisor of ``n`` up to ``target`` (``transformer.py:331``)."""
    for g in range(min(target, n), 0, -1):
        if n % g == 0:
            return g
    return 1


def _checkpoint(fn, *args):
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _scan_blocks(blocks, x, body, remat: bool):
    """``x`` through ``body(block, x)`` for each block in order
    (``transformer.py:338``).  With ``remat``, two levels as JAX's: one
    checkpoint a layer, inside one a group of :func:`_remat_group` layers
    (a single level when the group is one layer or all of them).  The
    backward then holds one residual a group, recomputes the group's
    forward to get its layers' inputs and each layer's forward once more
    for its own backward; nothing of the arithmetic changes."""
    if not remat:
        for block in blocks:
            x = body(block, x)
        return x
    n = len(blocks)
    group = _remat_group(n)
    if group <= 1 or group == n:
        for block in blocks:
            x = _checkpoint(body, block, x)
        return x

    def run_group(y, first):
        for block in blocks[first:first + group]:
            y = _checkpoint(body, block, y)
        return y

    for first in range(0, n, group):
        x = _checkpoint(run_group, x, first)
    return x


def block_forwards(cfg: ArchConfig, run: RunCfg) -> int:
    """Forward passes of the blocks in one training step (forward and
    backward of :func:`lm_loss`): one a layer without remat; with it, a
    layer's forward runs again for its own backward, and within a group of
    several layers the group's recompute stops, as torch's checkpoint
    does by default, once it has the last layer's input."""
    n = cfg.n_layers
    if not (run.remat and cfg.remat):
        return n
    group = _remat_group(n)
    if group <= 1 or group == n:
        return 2 * n
    return 3 * n - n // group


def forward(cfg: ArchConfig, run: RunCfg, params: Transformer, batch, *,
            collect_cache: bool = False, t_max: int = 0, last_only: bool = False):
    """Full-sequence forward over ``batch["tokens"]`` (B, S).  Returns
    (logits, cache|None): the cache holds every layer's k and v,
    ``(L, B, max(S, t_max), Hkv, Dh)`` in the compute dtype, zeros past S
    (JAX's stacked cache then ``pad_cache``, written in one buffer).
    ``last_only`` computes the head on the last position only.  Without a
    cache and with grad enabled, the blocks are rematerialised where
    ``run.remat`` and ``cfg.remat`` are both on (:func:`_scan_blocks`)."""
    check_supported(cfg)
    cd = _dt(cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(params, cfg, tokens)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    cache = None
    if collect_cache:
        shape = (cfg.n_layers, b, max(s, t_max), cfg.n_kv_heads, cfg.head_dim_)
        cache = {"k": torch.zeros(shape, dtype=cd, device=x.device),
                 "v": torch.zeros(shape, dtype=cd, device=x.device)}
        for i, block in enumerate(params.blocks):
            x, (k, v) = _uniform_block_fwd(_cast_f(block, cd), cfg, run, x,
                                           positions)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
    else:
        def body(block, y):
            return _uniform_block_fwd(_cast_f(block, cd), cfg, run, y, positions)[0]
        remat = run.remat and cfg.remat and torch.is_grad_enabled()
        x = _scan_blocks(params.blocks, x, body, remat)
    if last_only:
        x = x[:, -1:]
    x = _apply_norm(_cast_f(params.final_norm, None), x, cfg)
    return _head_out(params, cfg, x), cache


def lm_loss(cfg: ArchConfig, run: RunCfg, params: Transformer, batch):
    """Next-token cross entropy, mean over tokens (``transformer.py:767``):
    the logits cast to f32, ``logsumexp − gold`` for each position but the
    last against the next token."""
    logits, _ = forward(cfg, run, params, batch)
    logits = logits.float()[:, :-1]
    targets = batch["tokens"][:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (logz - gold).mean()


def init_cache(cfg: ArchConfig, b: int, t_max: int, device="cuda"):
    """A zero decode cache: k, v (L, B, t_max, Hkv, Dh) and ``len`` 0."""
    check_supported(cfg)
    cd = _dt(cfg)
    shape = (cfg.n_layers, b, t_max, cfg.n_kv_heads, cfg.head_dim_)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cd, device=dev),
            "v": torch.zeros(shape, dtype=cd, device=dev), "len": 0}


def pad_cache(cfg: ArchConfig, cache, s: int, t_max: int):
    """Pad a prefill cache's time axis to t_max and set len=s."""
    out = dict(cache)
    for key in ("k", "v"):
        a = cache[key]
        out[key] = torch.nn.functional.pad(
            a, (0, 0, 0, 0, 0, t_max - a.shape[2]))
    out["len"] = s
    return out


def decode_step(cfg: ArchConfig, run: RunCfg, params: Transformer, cache, tokens):
    """One greedy-decode step. tokens: (B, 1).  Returns (logits, cache);
    the cache's k and v are updated in place, ``len`` grows by one."""
    check_supported(cfg)
    cd = _dt(cfg)
    b = tokens.shape[0]
    clen = int(cache["len"])
    positions = torch.full((b, 1), clen, dtype=torch.long, device=tokens.device)
    y = _embed_tokens(params, cfg, tokens)
    a_dims = attn_dims(cfg)
    for i, block in enumerate(params.blocks):
        bp = _cast_f(block, cd)
        h = _apply_norm(bp["ln1"], y, cfg)
        y = y + L.apply_attention_decode(bp["attn"], a_dims, h, cache["k"][i],
                                         cache["v"][i], clen, positions)
        h = _apply_norm(bp["ln2"], y, cfg)
        y = y + L.apply_mlp(bp["ff"], h, cfg.mlp_type)
    y = _apply_norm(_cast_f(params.final_norm, None), y, cfg)
    return _head_out(params, cfg, y), {"k": cache["k"], "v": cache["v"],
                                        "len": clen + 1}


def prefill(cfg: ArchConfig, run: RunCfg, params: Transformer, batch,
            t_max: int = 0):
    """Forward over the prompt; returns the last position's logits
    (B, 1, vocab) and the cache padded to ``t_max`` with ``len`` = S."""
    logits, cache = forward(cfg, run, params, batch, collect_cache=True,
                            t_max=t_max, last_only=True)
    cache["len"] = batch["tokens"].shape[1]
    return logits, cache
