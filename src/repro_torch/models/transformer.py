"""The uniform decoder of the port: init, full-sequence forward, the
training loss, prefill and one-token greedy decode over a KV cache.

Port of the uniform path of ``repro.models.transformer`` (smollm,
deepseek, qwen, gemma: GQA/MQA, SwiGLU/GeGLU, optional QKV bias, RoPE,
RMSNorm or RMSNorm(1 + w), optional embedding scale, tied or untied head;
qwen3-moe: a Mixture of Experts as every block's feed-forward,
:mod:`repro_torch.models.moe`; deepseek-v2-lite: Multi-head Latent
Attention, :mod:`repro_torch.models.mla`, its ``first_dense`` leading
dense blocks and its shared experts; rwkv6-3b: RWKV-6 blocks,
:mod:`repro_torch.models.rwkv`).
Layers run as a Python loop over an ``nn.ModuleList`` a stack
(``first_blocks``, then ``blocks``: :data:`repro_torch.models.common.STACKS`)
where JAX scans over each stack's layer-stacked params; each block's
params are cast to the compute dtype where JAX's ``_cast_f`` casts them,
at the top of every block.  The attention of the forward (prefill and
training) is the flash-attention kernel (MLA's in its decompressed form).
Under autograd each stack's blocks are rematerialised as JAX's
``_scan_blocks`` does (:func:`_scan_blocks`: ``torch.utils.checkpoint``).

On a mesh (``RunCfg.mesh``, the ranks of :func:`repro_torch.dist.run_ranks`)
the model holds this rank's shards (:func:`shard_model`, the reference's
specs from :func:`model_axes` and :mod:`repro_torch.distributed.sharding`)
and runs as GSPMD runs the reference: the batch over the data axes; each
block's parameters all-gathered over ``data`` (FSDP) inside the block's
remat region, so the recompute gathers again, their gradients
reduce-scattered back; tensor parallelism over ``model`` where the specs
cut heads, mlp or vocab (:class:`repro_torch.models.layers.TP`): a
vocab-parallel embedding, tied logits on this rank's vocab block and a
distributed log-softmax in :func:`lm_loss`.  A MoE block's experts lie
over ``model``: the expert-parallel path (``impl="ep"``, the batch's rows
cut over the data axes) dispatches over it in all-to-alls
(:func:`repro_torch.models.moe.apply_moe_ep`); otherwise each rank
computes its experts' share of the reference's dense MoE over the whole
batch and the shares are summed over ``model`` (:func:`_ff_apply`).  A
batch whose rows do not divide over the data axes (B=1 decode on 2x2)
lies whole on every rank (``RunCfg.split_batch``), as GSPMD replicates it.

The decode cache holds k and v in the compute dtype, or with the config's
``kv_quant`` (a GQA model) int8 with an f32 scale a (token, head)
(:mod:`repro_torch.models.kvquant`): the prefill quantizes each layer's
entries as it writes them, the decode dequantizes a layer's cache, splices
the new token in unquantized, attends, and quantizes only the new entry
(the reference's ``bodyq``).  With ``RunCfg.seq_shard_kv`` on a mesh the
cache's time axis is cut over the data axes and the batch lies whole on
every rank: the prefill keeps this rank's time slab, the decode writes the
new entry where its slab holds it and combines the slabs' softmaxes by
log-sum-exp (:func:`_attn_decode`,
:func:`repro_torch.models.layers.decode_attention_seqsharded`).

RWKV (``mixer="rwkv"``, the reference's RWKV branches): ``ln0`` after the
embedding, then blocks of a time mix and a channel mix, each after its
LayerNorm.  Its decode cache is a state a layer, O(1) in the sequence's
length: the token-shift buffers ``x_tm`` and ``x_cm`` (the last ln1 and
ln2 outputs, (L, B, d), compute dtype) and the WKV matrix ``wkv`` (L, B,
H, K, K) f32; ``len`` counts positions.  Its recurrence is the ``wkv6``
kernel (:mod:`repro_torch.kernels.wkv`), one launch a layer for the
prefill and one a layer a decode step.  A block runs the prompt in chunks
of at most :data:`SEQ_CHUNK_TOKENS` tokens, carrying the state, so that a
long prompt (``long_500k``'s 524288 positions) holds a chunk's
activations, not the whole prompt's.  On a mesh each rank computes its
block of the heads (:func:`rwkv_tp`) and holds its heads' part of
``wkv``: the cache's heads are cut over ``model`` beside the reference's
``cache_specs``, which cut the states over the data axes only.  That
changes memory, not values.  Under autograd (:func:`lm_loss`) the blocks
run through :func:`_scan_blocks` with two-level remat, as the reference's
``_scan_blocks`` runs them, and the recurrence through ``wkv6``'s
``torch.autograd.Function`` (its backward the ``wkv6_bwd`` kernel, from
states kept every 16 steps: the reference's chunked remat of the time
scan); the chunks of the time axis carry the state's gradient back.

Jamba (``mixer="hybrid"``, the reference's hybrid branches): superblocks
of ``hybrid_period`` sub-layers (:class:`JambaBlock`), each a mixer and a
feed-forward after its RMSNorm: the attention at ``hybrid_attn_pos`` and a
Mamba layer (:mod:`repro_torch.models.mamba`) at the others, the MoE at
every ``moe.every``-th and the dense MLP at the rest; each kind's layers
stacked on a ``sub`` axis, as the reference stacks them.  A superblock's
parameters are cast to the compute dtype one sub-layer at a time, where
the reference casts the whole superblock (103.6 GB at f32 compute and
jamba-1.5-large's widths).  Its decode cache is the attention layer's k
and v (nb, B, T, Hkv, Dh), and each Mamba layer's conv tail ``conv`` (nb,
period − 1, B, d_conv − 1, d_inner; compute dtype) and SSM state ``ssm``
(nb, period − 1, B, d_inner, d_state; f32).  Its recurrence is the
``selective_scan`` kernel (:mod:`repro_torch.kernels.selective_scan`), one
launch a Mamba layer for the prefill and one a decode step.
:func:`init_model`'s ``experts`` makes one card's share of every MoE
layer's experts (:attr:`Transformer.held`): jamba-1.5-large's one
superblock, 45.2 B parameters, does not fit an 80 GB card, and the
deployment it is cut from puts each MoE layer's 16 experts over 2 chips,
expert-parallel, everything else whole on both; this card holds 8.  Jamba
is served and trained on one device; its mesh waits (ROADMAP Queue 1 item
11.6e).  Under autograd (:func:`lm_loss`) the superblocks run through
:func:`_scan_blocks` and each Mamba sub-layer is a checkpoint of its own,
as the reference's ``mamba_ck``; the recurrence goes through
``selective_scan``'s ``torch.autograd.Function`` (its backward the
``selective_scan_bwd`` kernel, from states kept every 16 steps).

Configs outside this path raise ``NotImplementedError`` naming ROADMAP
Queue 1 item 11: Whisper's encoder–decoder and the VLM ``embeds`` input.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH
from repro_torch.models import common as cm
from repro_torch.models import kvquant as KQ
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as RW
from repro_torch.models.common import STACKS

LM_ITEM = "ROADMAP Queue 1 item 11"
#: the most tokens (rows × positions) an RWKV block takes at once in the
#: prefill: a longer prompt runs in chunks, its state carried
SEQ_CHUNK_TOKENS = 1 << 16


@dataclasses.dataclass(frozen=True)
class RunCfg:
    """Runtime distribution context (orthogonal to the arch config).
    ``mesh`` is None on one device, else the running ranks' mesh as this
    rank sees it (:class:`repro_torch.distributed.sharding.Mesh`,
    :func:`repro_torch.launch.mesh.mesh_of`); :attr:`data_axes` and
    :attr:`model_axes` follow from it as the reference's launcher derives
    them (``mesh_axes``).  ``per_pod`` leaves ``pod`` out of the data axes:
    the compressed step's loss and gradients of each pod's rows.
    ``remat`` rematerialises the blocks in the backward where the config's
    ``remat`` is on too, as JAX's.  ``plain_attention`` sends the
    forward's attention through the kernel's plain version on any device;
    it is off on the main path and exists to compare the two.
    ``plain_wkv`` sends RWKV's recurrence through the ``wkv6`` kernel's
    plain version on any device, and ``plain_scan`` Mamba's through the
    ``selective_scan`` kernel's, likewise to compare the two.
    ``split_batch`` (on a mesh): the batch's rows are cut over the data
    axes; off, every rank holds the whole batch (serving a batch that does
    not divide over them, :func:`batch_run`; :func:`local_rows` and
    :func:`gather_rows` then keep it whole).  ``seq_shard_kv`` (on a mesh;
    nothing without one, as the reference's): the sequence-sharded decode,
    the GQA cache's time axis cut over the data axes (``cache_specs``), the
    batch whole on every rank (:func:`batch_run`)."""
    mesh: SH.Mesh | None = None
    per_pod: bool = False
    plain_attention: bool = False
    plain_wkv: bool = False
    plain_scan: bool = False
    remat: bool = True
    split_batch: bool = True
    seq_shard_kv: bool = False

    def __post_init__(self):
        if self.mesh is not None and not isinstance(self.mesh, SH.Mesh):
            raise TypeError(f"RunCfg.mesh must be a sharding.Mesh or None, got "
                            f"{type(self.mesh).__name__}")

    @property
    def data_axes(self) -> tuple:
        """The batch and FSDP axes of the mesh (``pod`` first where it has
        one, unless ``per_pod``)."""
        if self.mesh is None:
            return ("data",)
        axes = SH.mesh_axes(self.mesh)[0]
        return tuple(a for a in axes if not (self.per_pod and a == "pod"))

    @property
    def model_axes(self) -> tuple:
        """The tensor-parallel axes."""
        return SH.mesh_axes(self.mesh)[1] if self.mesh is not None else ("model",)


def check_supported(cfg: ArchConfig, *, mesh: bool = False,
                    training: bool = False) -> None:
    """Raise for what this slice does not run: on one device, or with
    ``mesh`` on a mesh; with ``training``, trained.  It trains all it
    serves."""
    left = []
    if cfg.moe is not None and cfg.moe.every != 1 and cfg.mixer != "hybrid":
        left.append("MoE with dense blocks among its layers")
    if cfg.mixer not in ("attn", "rwkv", "hybrid"):
        left.append(f"mixer {cfg.mixer!r}")
    if cfg.mixer == "hybrid" and mesh:
        left.append("the Jamba hybrid on a mesh, served or trained (item 11.6e)")
    if cfg.encdec:
        left.append("encoder-decoder")
    if cfg.embed_mode != "tokens":
        left.append(f"embed_mode {cfg.embed_mode!r}")
    if left:
        raise NotImplementedError(
            f"{cfg.arch_id}: {', '.join(left)} not ported yet ({LM_ITEM}); the "
            "port runs the uniform decoder, dense or MoE, GQA or MLA, RWKV, and "
            "the Jamba hybrid on one device")
    if _quantized(cfg) and stack_sizes(cfg)["first_blocks"]:
        raise ValueError(
            f"{cfg.arch_id}: the int8 KV cache (kv_quant) with first_dense leading "
            "blocks: the reference's decode takes its float branch there and casts "
            "the new entries to int8 unscaled; no config has it")


def _quantized(cfg: ArchConfig) -> bool:
    """The decode cache is int8 with scales: ``kv_quant`` on a GQA model
    (MLA keeps its compressed cache, as the reference's ``init_cache``;
    RWKV has no KV cache)."""
    return cfg.kv_quant and cfg.attn_kind == "gqa" and cfg.mixer == "attn"


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


def mla_dims(cfg: ArchConfig) -> MLA.MLADims:
    m = cfg.mla
    return MLA.MLADims(d_model=cfg.d_model, n_heads=cfg.n_heads,
                       kv_lora_rank=m.kv_lora_rank, qk_nope_dim=m.qk_nope_dim,
                       qk_rope_dim=m.qk_rope_dim, v_head_dim=m.v_head_dim,
                       rope_base=cfg.rope_base)


def rwkv_dims(cfg: ArchConfig) -> RW.RWKVDims:
    return RW.RWKVDims(d_model=cfg.d_model, n_heads=cfg.n_heads, d_ff=cfg.d_ff)


def mamba_dims(cfg: ArchConfig) -> MB.MambaDims:
    mc = cfg.mamba
    return MB.MambaDims(d_model=cfg.d_model, d_state=mc.d_state, d_conv=mc.d_conv,
                        expand=mc.expand)


def stack_sizes(cfg: ArchConfig) -> dict:
    """``{stack: its blocks}`` in :data:`STACKS` order: a MoE config's
    ``first_dense`` leading dense blocks, then the rest (Jamba's: its
    superblocks of ``hybrid_period`` layers)."""
    if cfg.mixer == "hybrid":
        return {"first_blocks": 0, "blocks": cfg.n_layers // cfg.hybrid_period}
    nd = cfg.moe.first_dense if cfg.moe is not None else 0
    return {"first_blocks": nd, "blocks": cfg.n_layers - nd}


def moe_dims(cfg: ArchConfig) -> MOE.MoEDims:
    m = cfg.moe
    return MOE.MoEDims(d_model=cfg.d_model, n_experts=m.n_experts,
                       top_k=m.top_k, d_ff_expert=m.d_ff_expert,
                       n_shared=m.n_shared, d_ff_shared=m.d_ff_shared,
                       capacity_factor=m.capacity_factor,
                       router_norm_topk=m.router_norm_topk,
                       mlp_type=cfg.mlp_type)


# ---------------------------------------------------------------------------
# init (parameter names as the JAX params' keys)
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """``_norm_param``: RMSNorm weight (zeros for RMSNorm(1 + w)) or
    LayerNorm weight and bias."""

    AXES = {"w": ("embed",), "b": ("embed",)}

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
    """``_init_uniform_block`` of ``stack``: GQA or MLA as ``attn``; the
    MoE as ``ff`` in a MoE config's ``blocks`` (``held``: its block of the
    experts, :class:`repro_torch.models.moe.MoE`), else the dense MLP (a
    MoE config's ``first_blocks`` and every block of a dense one).
    ``stack`` names the specs its parameters are cut by."""

    def __init__(self, ini, cfg: ArchConfig, stack: str, held: tuple | None = None):
        super().__init__()
        self.stack = stack
        self.ln1 = Norm(ini, cfg)
        self.ln2 = Norm(ini, cfg)
        if cfg.attn_kind == "mla":
            self.attn = MLA.MLA(ini, mla_dims(cfg))
        else:
            self.attn = L.Attention(ini, attn_dims(cfg))
        if cfg.moe is not None and stack == "blocks":
            self.ff = MOE.MoE(ini, moe_dims(cfg), held)
        else:
            self.ff = L.MLP(ini, cfg.d_model, cfg.d_ff, cfg.mlp_type)


class RWKVBlock(nn.Module):
    """``_init_rwkv_block`` (``transformer.py:127``): ``ln1``, ``ln2``, the
    time mix ``tm`` and the channel mix ``cm``."""

    def __init__(self, ini, cfg: ArchConfig, stack: str):
        super().__init__()
        self.stack = stack
        self.ln1 = Norm(ini, cfg)
        self.ln2 = Norm(ini, cfg)
        self.tm = RW.RWKVTimeMix(ini, rwkv_dims(cfg))
        self.cm = RW.RWKVChannelMix(ini, rwkv_dims(cfg))


def _on_sub(module: nn.Module) -> nn.Module:
    """Mark ``module`` and its submodules as stacked on a superblock's
    ``sub`` axis (made by :meth:`repro_torch.models.common.Initializer.stacked`):
    :func:`model_axes` puts ``sub`` before their axes."""
    for m in module.modules():
        m.on_sub = True
    return module


class JambaBlock(nn.Module):
    """``_init_jamba_superblock`` (``transformer.py:143``): one period of
    ``hybrid_period`` sub-layers, their RMSNorm weights ``ln1``, ``ln2``
    (period, d); the attention ``attn``; the period − 1 Mamba layers
    ``mamba``, the period / ``moe.every`` MoE layers ``moe`` (``held``: the
    block of each one's experts) and the dense MLPs ``mlp``, each kind's
    leaves stacked on ``sub``."""

    AXES = {"ln1": ("sub", "embed"), "ln2": ("sub", "embed")}

    def __init__(self, ini, cfg: ArchConfig, stack: str, held: tuple | None = None):
        super().__init__()
        self.stack = stack
        per, d = cfg.hybrid_period, cfg.d_model
        n_moe = per // cfg.moe.every
        self.ln1 = ini.param((per, d), mode="ones")
        self.ln2 = ini.param((per, d), mode="ones")
        self.attn = L.Attention(ini, attn_dims(cfg))
        self.mamba = _on_sub(MB.Mamba(ini.stacked(per - 1), mamba_dims(cfg)))
        self.moe = _on_sub(MOE.MoE(ini.stacked(n_moe), moe_dims(cfg), held))
        self.mlp = _on_sub(L.MLP(ini.stacked(per - n_moe), d, cfg.d_ff, cfg.mlp_type))


class Transformer(nn.Module):
    """``init_model``'s uniform, RWKV and hybrid branches: ``embed`` (vocab,
    d), ``final_norm``, ``head`` (d, vocab) unless tied, RWKV's ``ln0``,
    ``first_blocks`` (a MoE config's ``first_dense`` dense blocks; empty
    otherwise) and ``blocks`` (one :class:`Block`, :class:`RWKVBlock` or
    :class:`JambaBlock` a layer or superblock, where JAX stacks each on a
    leading axis).  ``held`` (first, count): the block of every MoE
    layer's experts it holds (None: all).  With ``mesh`` each parameter is
    cut to this rank's shard (:func:`shard_model`) as soon as its block
    (or the top-level leaves) is made, so that no more than a block's
    whole parameters are ever held."""

    AXES = {"embed": ("vocab", "embed"), "head": ("embed", "vocab")}

    def __init__(self, cfg: ArchConfig, ini, mesh: SH.Mesh | None = None,
                 held: tuple | None = None):
        super().__init__()
        check_supported(cfg, mesh=mesh is not None)
        if held is not None and (cfg.moe is None or mesh is not None):
            raise ValueError(f"{cfg.arch_id}: held experts {held} are one card's share of "
                             "a MoE model's experts (on a mesh the model axes cut them)")
        self.cfg = cfg
        self.held = None if held is None else tuple(held)
        d = cfg.d_model
        specs = None if mesh is None else param_specs(cfg, mesh)
        self.embed = ini.param((cfg.vocab, d), scale=1.0 / d ** 0.5)
        self.final_norm = Norm(ini, cfg)
        if not cfg.tie_embeddings:
            self.head = ini.param((d, cfg.vocab))
        if cfg.mixer == "rwkv":
            self.ln0 = Norm(ini, cfg)
        if specs is not None:
            _shard_params(self, "", specs, mesh)
        for stack, n in stack_sizes(cfg).items():
            blocks = nn.ModuleList()
            setattr(self, stack, blocks)
            for i in range(n):
                if cfg.mixer == "rwkv":
                    blocks.append(RWKVBlock(ini, cfg, stack))
                else:
                    kind = JambaBlock if cfg.mixer == "hybrid" else Block
                    blocks.append(kind(ini, cfg, stack, self.held))
                if specs is not None:
                    _shard_params(blocks[i], f"{stack}.{i}.", specs, mesh)

    @property
    def first_expert(self) -> int:
        """The first of the experts each MoE layer holds (0 where it holds
        them all)."""
        return 0 if self.held is None else self.held[0]


def init_model(cfg: ArchConfig, seed: int = 0, device="cuda",
               mesh: SH.Mesh | None = None, experts: tuple | None = None) -> Transformer:
    """Random parameters from ``seed`` on ``device`` (``"meta"`` for shapes
    only), in ``cfg.param_dtype``; with ``mesh``, this rank's shards of
    them (the same values as :func:`shard_model` of the whole model).
    ``experts`` (first, count), on one device: only that block of every MoE
    layer's experts, the router whole: one card's share of an
    expert-parallel deployment, jamba-1.5-large's 16 experts over 2 chips,
    of which this card holds 8.  Each MoE layer then gives the share of its
    output of the pairs routed to them (routing and capacity those of all
    its experts), and that partial result goes on to the next layer."""
    dev = torch.device(device)
    gen = None if dev.type == "meta" else torch.Generator(
        device=resolve_device(dev)).manual_seed(seed)
    return Transformer(cfg, cm.Initializer(gen, cm.dtype_of(cfg.param_dtype), dev),
                       mesh=mesh, held=experts)


def model_axes(cfg: ArchConfig) -> dict:
    """Each parameter's logical axes, ``{port name: axes}``: the
    reference's ``model_axes`` (``transformer.py:216``) under the port's
    names, a block's without the leading ``layers`` axis that JAX stacks
    (:func:`repro_torch.models.convert.axes_to_jax_tree` stacks them); a
    superblock's stacked sub-layers with ``sub`` first."""
    model = init_model(cfg, device="meta")
    out = {}
    for mname, module in model.named_modules():
        sub = ("sub",) if getattr(module, "on_sub", False) else ()
        for pname, _ in module.named_parameters(recurse=False):
            out[f"{mname}.{pname}" if mname else pname] = sub + type(module).AXES[pname]
    return out


@functools.lru_cache(maxsize=None)
def _specs(cfg: ArchConfig, mesh_shape: tuple) -> dict:
    model = init_model(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return {n: SH.spec_for(dict(mesh_shape), ax, shapes[n], SH.PARAM_RULES)
            for n, ax in model_axes(cfg).items()}


def param_specs(cfg: ArchConfig, mesh) -> dict:
    """``{port name: spec}`` of every parameter on ``mesh`` (its
    ``shape``), by the reference's ``PARAM_RULES``."""
    return _specs(cfg, tuple(SH.shape_of(mesh).items()))


def block_specs(cfg: ArchConfig, mesh, stack: str) -> dict:
    """The specs of a block's parameters in ``stack``, by their names in
    the block (every block of a stack has the same)."""
    return _block_specs(cfg, tuple(SH.shape_of(mesh).items()), stack)


@functools.lru_cache(maxsize=None)
def _block_specs(cfg: ArchConfig, mesh_shape: tuple, stack: str) -> dict:
    first = f"{stack}.0."
    return {n[len(first):]: s for n, s in _specs(cfg, mesh_shape).items()
            if n.startswith(first)}


@torch.no_grad()
def _shard_params(module: nn.Module, prefix: str, specs: dict, mesh: SH.Mesh) -> None:
    """Replace each parameter of ``module`` (``prefix`` + its name in
    ``specs``) not yet cut by this rank's shard of it (a contiguous copy;
    the full tensor is let go leaf by leaf)."""
    for name, p in list(module.named_parameters()):
        full = prefix + name
        if not prefix and cm.split_stacked(full):
            continue  # a block cuts its own
        *path, leaf = name.split(".")
        owner = module.get_submodule(".".join(path))
        shard = SH.shard_of(p.data, specs[full], mesh).contiguous()
        setattr(owner, leaf, nn.Parameter(shard, requires_grad=p.requires_grad))


def shard_model(model: Transformer, mesh: SH.Mesh) -> Transformer:
    """Replace each parameter of ``model`` (full logical shapes) by this
    rank's shard of it on ``mesh`` (a contiguous copy; the full tensor is
    let go leaf by leaf); returns the model."""
    specs = param_specs(model.cfg, mesh)
    _shard_params(model, "", specs, mesh)
    for stack in STACKS:
        for i, block in enumerate(getattr(model, stack)):
            _shard_params(block, f"{stack}.{i}.", specs, mesh)
    return model


#: the bytes of this rank's shards that one packed FSDP gather carries (a
#: larger leaf is a pack of its own): it bounds the gather's buffers and
#: its gradient's reduce-scatter, and the wire's landing slots
PACK_BYTES = 1 << 28


def _packs(leaves: list, named: dict) -> list:
    """``leaves`` ((name, dim) pairs) in order, cut into runs of at most
    :data:`PACK_BYTES` of their shards."""
    out, size = [[]], 0
    for name, dim in leaves:
        nbytes = named[name].numel() * named[name].element_size()
        if out[-1] and size + nbytes > PACK_BYTES:
            out.append([])
            size = 0
        out[-1].append((name, dim))
        size += nbytes
    return out


def _fsdp_gather(named: dict, specs: dict, run: RunCfg) -> dict:
    """``named`` ({name: shard}) with each leaf gathered over the axes of
    its spec other than the model axes (FSDP), one packed exchange an axis
    for leaves cut over the same axes (a pack at most :data:`PACK_BYTES`
    of shards); the model axes' cut stays.  A leaf whole on a batch axis
    is shared over it (:func:`C.copy_to_packed`: its gradient, from this
    rank's rows only, summed there), so that every leaf's gradient is the
    global batch's."""
    out = dict(named)
    groups: dict = {}
    shared: dict = {}
    for name, spec in specs.items():
        for dim, entry in enumerate(spec):
            axes = tuple(a for a in SH.entry_axes(entry) if a not in run.model_axes)
            if axes:
                groups.setdefault(axes, []).append((name, dim))
        left = tuple(a for a in run.data_axes if run.mesh.shape.get(a, 1) > 1
                     and a not in SH.spec_axes(spec))
        if left:
            shared.setdefault(left, []).append(name)
    for axes, leaves in groups.items():
        for pack in _packs(leaves, named):
            got = C.gather_packed([named[n] for n, _ in pack], [d for _, d in pack], axes)
            out.update({n: g for (n, _), g in zip(pack, got)})
    for axes, names in shared.items():
        out.update(zip(names, C.copy_to_packed([out[n] for n in names], axes)))
    return out


def _nest(named: dict, dtype: torch.dtype | None) -> dict:
    """A flat ``{dotted name: tensor}`` as a nested dict, floating leaves
    cast to ``dtype`` (None keeps their dtype)."""
    tree: dict = {}
    for name, p in named.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.to(dtype) if dtype and p.is_floating_point() else p
    return tree


def _cast_for_gather(named: dict, dtype: torch.dtype, names=None) -> dict:
    """``named`` with each floating leaf (of ``names``; None: every one)
    that no gradient flows through cast to ``dtype`` already: the cast
    commutes with the FSDP gather, which then moves the compute dtype's
    bytes (prefill and decode).  A leaf under autograd keeps its dtype, so
    that its gradient is reduce-scattered in it."""
    grad = torch.is_grad_enabled()
    return {n: p.to(dtype) if (names is None or n in names) and p.is_floating_point()
            and not (grad and p.requires_grad) else p for n, p in named.items()}


def _block_params(block: Block, cfg: ArchConfig, run: RunCfg, dtype) -> dict:
    """A block's parameters as :func:`_cast_f` gives them; on a mesh
    gathered over the FSDP axes first, by its stack's specs."""
    if run.mesh is None:
        return _cast_f(block, dtype)
    named = _cast_for_gather(dict(block.named_parameters()), dtype)
    return _nest(_fsdp_gather(named, block_specs(cfg, run.mesh, block.stack), run), dtype)


def _top_params(params: Transformer, cfg: ArchConfig, run: RunCfg) -> dict:
    """``embed``, ``final_norm`` and ``head`` as a nested dict (their dtype
    kept); on a mesh gathered over the FSDP axes, in one exchange an
    axis, ``embed`` and ``head`` in the compute dtype where no gradient
    flows (their rows and product are cast to it after the gather)."""
    named = {n: p for n, p in params.named_parameters() if not cm.split_stacked(n)}
    if run.mesh is not None:
        specs = {n: s for n, s in param_specs(cfg, run.mesh).items() if n in named}
        named = _fsdp_gather(_cast_for_gather(named, _dt(cfg), ("embed", "head")),
                             specs, run)
    return _nest(named, None)


def _tp_axes(run: RunCfg, entry) -> tuple:
    return tuple(a for a in SH.entry_axes(entry) if a in run.model_axes)


@functools.lru_cache(maxsize=None)
def _vocab_block(cfg: ArchConfig, run: RunCfg) -> tuple:
    """(model axes, first id, count) of this rank's vocab block; ``((), 0,
    vocab)`` where the vocab is whole."""
    if run.mesh is None:
        return (), 0, cfg.vocab
    specs = param_specs(cfg, run.mesh)
    entry = specs["embed"][0] if cfg.tie_embeddings else specs["head"][1]
    axes = _tp_axes(run, entry)
    if not axes:
        return (), 0, cfg.vocab
    idx, count = SH.shard_index(axes, run.mesh)
    n = cfg.vocab // count
    return axes, idx * n, n


@functools.lru_cache(maxsize=None)
def attn_tp(cfg: ArchConfig, run: RunCfg, *, cache: bool = False) -> L.TP:
    """How the model axes cut attention on ``run.mesh`` (and, with
    ``cache``, the decode cache of :func:`cache_layout`)."""
    if run.mesh is None:
        return L.NO_TP
    bs = block_specs(cfg, run.mesh, "blocks")
    axes = _tp_axes(run, bs["attn.wq"][1])
    if cfg.attn_kind == "mla":
        # wq, w_uk, w_uv, wo by heads; the latents and the cache whole
        return L.TP(axes=axes)
    kv = None
    if axes and not _tp_axes(run, bs["attn.wk"][1]):
        # query heads cut, kv heads whole: each local query head reads its
        # kv head h // g of all of them
        idx, count = SH.shard_index(axes, run.mesh)
        hl = cfg.n_heads // count
        g = cfg.n_heads // cfg.n_kv_heads
        h0 = idx * hl
        kv = (slice(h0 // g, (h0 + hl) // g) if h0 % g == 0 and hl % g == 0
              else [h // g for h in range(h0, h0 + hl)])
    if not cache:
        return L.TP(axes=axes, kv=kv)
    spec = cache_layout(cfg, run, 1)["k"]
    for dim in (3, 4):
        cut = _tp_axes(run, spec[dim])
        if cut:
            idx, count = SH.shard_index(cut, run.mesh)
            n = (cfg.n_kv_heads if dim == 3 else cfg.head_dim_) // count
            return L.TP(axes=axes, kv=kv, cache_dim=dim, cache_axes=cut,
                        cache_block=(idx * n, (idx + 1) * n))
    return L.TP(axes=axes, kv=kv)


@functools.lru_cache(maxsize=None)
def mlp_tp(cfg: ArchConfig, run: RunCfg, prefix: str = "ff.") -> L.TP:
    """How the model axes cut the MLP at ``prefix`` of a block (a dense
    block's ``ff``, a MoE block's shared MLP ``ff.shared.``), by the specs
    of the stack whose blocks hold it."""
    if run.mesh is None:
        return L.NO_TP
    for stack in STACKS:
        bs = block_specs(cfg, run.mesh, stack)
        for name in (prefix + "wi_gate", prefix + "wi"):
            if name in bs:
                return L.TP(axes=_tp_axes(run, bs[name][1]))
    raise KeyError(f"no block of {cfg.name} has an MLP at {prefix!r}")


@functools.lru_cache(maxsize=None)
def rwkv_tp(cfg: ArchConfig, run: RunCfg) -> RW.RWKVTP:
    """How the model axes cut an RWKV block on ``run.mesh``: the time mix's
    heads (``Wr``'s columns; this rank's block of whole heads), the channel
    mix's ``mlp`` (``Wk``'s columns) and ``embed_out`` (``Wr``'s)."""
    if run.mesh is None:
        return RW.NO_TP
    bs = block_specs(cfg, run.mesh, "blocks")
    axes = _tp_axes(run, bs["tm.Wr"][1])
    heads = None
    if axes:
        idx, count = SH.shard_index(axes, run.mesh)
        if cfg.n_heads % count:
            raise ValueError(f"{cfg.arch_id}: the model axes {axes} ({count} ranks) cut "
                             f"{cfg.n_heads} RWKV heads mid-head")
        hl = cfg.n_heads // count
        heads = (idx * hl, hl)
    return RW.RWKVTP(axes=axes, heads=heads, mlp_axes=_tp_axes(run, bs["cm.Wk"][1]),
                     out_axes=_tp_axes(run, bs["cm.Wr"][1]))


@functools.lru_cache(maxsize=None)
def expert_block(cfg: ArchConfig, run: RunCfg) -> tuple:
    """(model axes, first expert) of this rank's block of a MoE block's
    experts on ``run.mesh``, and the router's model axes; ``((), 0, ())``
    where they are whole (one device, or experts that do not divide)."""
    if run.mesh is None:
        return (), 0, ()
    bs = block_specs(cfg, run.mesh, "blocks")
    axes = _tp_axes(run, bs["ff.experts.wi_gate"][0])
    first = 0
    if axes:
        idx, count = SH.shard_index(axes, run.mesh)
        first = idx * (cfg.moe.n_experts // count)
    return axes, first, _tp_axes(run, bs["ff.router"][1])


def cache_shapes(cfg: ArchConfig, b: int, t: int) -> dict:
    """The whole decode cache's shapes for ``b`` rows of ``t`` positions
    (the reference's ``init_cache``): k and v (L, B, T, Hkv, Dh), with
    ``kv_quant`` also their scales ``k_scale``, ``v_scale`` (L, B, T, Hkv,
    1); MLA's k the latents (L, B, T, kv_lora_rank) and v the RoPE keys
    (L, B, T, qk_rope_dim), the first stack's layers before the rest;
    RWKV's states, no time axis: ``x_tm``, ``x_cm`` (L, B, d) and ``wkv``
    (L, B, H, K, K); Jamba's k and v a superblock (nb, B, T, Hkv, Dh) and
    its Mamba layers' states, ``conv`` (nb, period − 1, B, d_conv − 1,
    d_inner) and ``ssm`` (nb, period − 1, B, d_inner, d_state)."""
    if cfg.mixer == "hybrid":
        md, (nb, per) = mamba_dims(cfg), (stack_sizes(cfg)["blocks"], cfg.hybrid_period)
        kv = (nb, b, t, cfg.n_kv_heads, cfg.head_dim_)
        return {"k": kv, "v": kv, "conv": (nb, per - 1, b, md.d_conv - 1, md.d_inner),
                "ssm": (nb, per - 1, b, md.d_inner, md.d_state)}
    if cfg.mixer == "rwkv":
        hs = rwkv_dims(cfg).head_size
        d = (cfg.n_layers, b, cfg.d_model)
        return {"x_tm": d, "wkv": (cfg.n_layers, b, cfg.n_heads, hs, hs), "x_cm": d}
    if cfg.attn_kind == "mla":
        m = cfg.mla
        return {"k": (cfg.n_layers, b, t, m.kv_lora_rank),
                "v": (cfg.n_layers, b, t, m.qk_rope_dim)}
    shape = (cfg.n_layers, b, t, cfg.n_kv_heads, cfg.head_dim_)
    out = {"k": shape, "v": shape}
    if _quantized(cfg):
        out.update(k_scale=shape[:4] + (1,), v_scale=shape[:4] + (1,))
    return out


def cache_dtypes(cfg: ArchConfig) -> dict:
    """Each cache entry's dtype: the compute dtype; with ``kv_quant`` int8
    k and v and f32 scales; RWKV's ``wkv`` and Jamba's ``ssm`` f32."""
    if cfg.mixer == "hybrid":
        return {"k": _dt(cfg), "v": _dt(cfg), "conv": _dt(cfg), "ssm": torch.float32}
    if cfg.mixer == "rwkv":
        return {"x_tm": _dt(cfg), "wkv": torch.float32, "x_cm": _dt(cfg)}
    if _quantized(cfg):
        return {"k": torch.int8, "v": torch.int8, "k_scale": torch.float32,
                "v_scale": torch.float32}
    return {"k": _dt(cfg), "v": _dt(cfg)}


def cache_layout(cfg: ArchConfig, run: RunCfg, b: int, t: int = 1) -> dict:
    """The decode cache's specs on ``run.mesh`` (the reference's
    ``cache_specs`` for a cache of ``b`` rows and ``t`` positions, its
    time axis cut where :func:`time_cut` cuts it; RWKV's ``wkv`` also cut
    over the model axes of its heads, :func:`rwkv_tp`)."""
    shapes = {k: torch.empty(s, device="meta") for k, s in cache_shapes(cfg, b, t).items()}
    specs = SH.cache_specs(run.mesh, shapes, cfg, seq_shard=time_cut(cfg, run) is not None)
    if cfg.mixer == "rwkv":
        axes = rwkv_tp(cfg, run).axes
        if axes:
            spec = list(specs["wkv"])
            spec[2] = axes if len(axes) > 1 else axes[0]
            specs["wkv"] = tuple(spec)
    return specs


def time_cut(cfg: ArchConfig, run: RunCfg):
    """``(axes, index, count)`` of this rank's slab of the cache's time
    axis where ``run.seq_shard_kv`` cuts it (the data axes of
    ``cache_specs``, a GQA cache: MLA's compressed cache stays whole, as
    the reference's MLA decode never takes the sequence-sharded path; RWKV
    has no time axis); None where it is whole."""
    if not run.seq_shard_kv or run.mesh is None or cfg.attn_kind != "gqa" \
            or cfg.mixer != "attn":
        return None
    axes = SH.cache_batch_axes(run.mesh)
    idx, count = SH.shard_index(axes, run.mesh)
    return (axes, idx, count) if count > 1 else None


# ---------------------------------------------------------------------------
# forward (prefill) and decode
# ---------------------------------------------------------------------------


def _live_data_axes(run: RunCfg) -> tuple:
    return tuple(a for a in run.data_axes if run.mesh.shape.get(a, 1) > 1)


def _ff_apply(p, cfg: ArchConfig, run: RunCfg, x, first: int = 0):
    """The feed-forward of a block (``transformer.py:233``):
    the MLP (a block without a router), or the MoE.  On a mesh, a MoE's router is gathered whole over the model axes
    (its gradient, a share on each rank, summed back by the gather's
    backward).  The expert-parallel path where the config's ``impl`` is
    ``"ep"``, the experts are cut over the model axes and the batch's rows
    over the data axes; else the reference's dense MoE over the whole
    batch (the rows gathered over the data axes where they are cut), each
    rank its experts' share, summed over the model axes.  Where
    ``moe.routing`` replays a recorded run, its next expert choices (the
    global batch's) are cut to the rows this rank routes.  ``first``, on one
    device: the first of the experts the model holds
    (:attr:`Transformer.first_expert`)."""
    if "router" not in p:
        return L.apply_mlp(p, x, cfg.mlp_type, tp=mlp_tp(cfg, run, "ff."))
    m = moe_dims(cfg)
    pinned = MOE.next_pinned()  # the global batch's (B, S, k), or None
    if pinned is not None:
        pinned = pinned.to(x.device)
    if run.mesh is None:
        return MOE.apply_moe(p, m, x, first=first, pinned=_flat_rows(pinned))
    axes, first, raxes = expert_block(cfg, run)
    if raxes:
        p = dict(p, router=C.gather_packed([p["router"]], [1], raxes)[0])
    stp = mlp_tp(cfg, run, "ff.shared.") if "shared" in p else L.NO_TP
    if cfg.moe.impl == "ep" and axes and run.split_batch:
        mine = None if pinned is None else _flat_rows(local_rows(pinned, run))
        return MOE.apply_moe_ep(p, m, x, model_axes=axes, chunks=cfg.moe.chunks,
                                shared_tp=stp, pinned=mine)
    rows = _live_data_axes(run) if run.split_batch else ()
    xg = C.gather_packed([x], [0], rows)[0] if rows else x
    out = C.reduce_from(MOE.apply_moe(p, m, C.copy_to(xg, axes), first=first,
                                      shared=False, pinned=_flat_rows(pinned)), axes)
    if rows:
        out = local_rows(out, run)
    if "shared" in p:
        out = out + L.apply_mlp(p["shared"], x, m.mlp_type, tp=stp)
    return out


def _flat_rows(t):
    return None if t is None else t.reshape(-1, t.shape[-1])


def _uniform_block_fwd(p, cfg: ArchConfig, run: RunCfg, x, positions, first: int):
    h = _apply_norm(p["ln1"], x, cfg)
    if cfg.attn_kind == "mla":
        a, kv = MLA.apply_mla(p["attn"], mla_dims(cfg), h, positions,
                              plain=run.plain_attention, tp=attn_tp(cfg, run))
    else:
        a, kv = L.apply_attention(p["attn"], attn_dims(cfg), h, positions,
                                  plain=run.plain_attention, tp=attn_tp(cfg, run))
    x = x + a
    h = _apply_norm(p["ln2"], x, cfg)
    x = x + _ff_apply(p["ff"], cfg, run, h, first)
    return x, kv


def _layers(params: Transformer):
    """Every layer's block in order: the cache's layers."""
    return [block for stack in STACKS for block in getattr(params, stack)]


def _embed_tokens(top: dict, cfg: ArchConfig, run: RunCfg, tokens):
    """The tokens' embeddings in the compute dtype; on a vocab block,
    rows of other ids are zero and the blocks are summed over the model
    axes (one rank's row is not zero)."""
    cd = _dt(cfg)
    axes, v0, n = _vocab_block(cfg, run)
    ids = tokens.long()
    if axes:
        local = ids - v0
        mine = (local >= 0) & (local < n)
        rows = top["embed"][local.clamp(0, n - 1)] * mine[..., None]
        x = C.reduce_from(rows.to(cd), axes)
    else:
        x = top["embed"][ids].to(cd)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cd)
    return x


def _head_out(top: dict, cfg: ArchConfig, run: RunCfg, x):
    """Logits in the compute dtype, as JAX (its f32 upcast is in the loss);
    on a vocab block, this rank's block of them."""
    axes, _, _ = _vocab_block(cfg, run)
    w = top["embed"].T if cfg.tie_embeddings else top["head"]
    return C.copy_to(x, axes) @ w.to(x.dtype)


def full_vocab(cfg: ArchConfig, run: RunCfg, logits):
    """Logits over the whole vocab: a vocab block's gathered over the
    model axes (no autograd)."""
    axes, _, _ = _vocab_block(cfg, run)
    return C.all_gather(logits, axes, dim=-1) if axes else logits


def gather_rows(x, run: RunCfg):
    """The global batch of a tensor of this rank's rows: gathered over the
    data axes (no autograd; whole already unless ``run.split_batch``)."""
    if run.mesh is None or not run.split_batch:
        return x
    return C.all_gather(x, tuple(a for a in run.data_axes if a in run.mesh.shape), dim=0)


def batch_run(run: RunCfg, b: int) -> RunCfg:
    """``run`` for a batch of ``b`` rows: with ``split_batch`` off where
    they do not divide over the data axes or the cache's time axis lies
    over them (``seq_shard_kv``; the reference's ``P()`` batch): every rank
    then holds them all."""
    if run.mesh is None:
        return run
    count = math.prod(run.mesh.shape[a] for a in run.data_axes if a in run.mesh.shape)
    if b % count == 0 and not run.seq_shard_kv:
        return run
    return dataclasses.replace(run, split_batch=False)


def local_rows(x, run: RunCfg, axes=None):
    """This rank's rows (dim 0) of a global batch tensor: cut over the
    data axes (``batch_spec``), row-major (whole unless
    ``run.split_batch``)."""
    if run.mesh is None or not run.split_batch:
        return x
    axes = tuple(a for a in (run.data_axes if axes is None else axes)
                 if a in run.mesh.shape)
    idx, count = SH.shard_index(axes, run.mesh)
    n = x.shape[0] // count
    return x[idx * n:(idx + 1) * n]


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
    backward of :func:`lm_loss`), summed over the stacks, each scanned on
    its own as JAX does: one a layer without remat; with it, a layer's
    forward runs again for its own backward, and within a group of
    several layers the group's recompute stops, as torch's checkpoint
    does by default, once it has the last layer's input."""
    remat = run.remat and cfg.remat
    total = 0
    for n in stack_sizes(cfg).values():
        group = _remat_group(n)
        if not remat:
            total += n
        elif group <= 1 or group == n:
            total += 2 * n
        else:
            total += 3 * n - n // group
    return total


def scan_forwards(cfg: ArchConfig, run: RunCfg) -> int:
    """Jamba's Mamba forward passes (``selective_scan`` launches) in one
    training step's forward and backward of :func:`lm_loss`: each Mamba
    layer's as often as its superblock's (:func:`block_forwards`), and with
    remat once more for its own checkpoint's backward.  Its backward runs
    once a Mamba layer (``selective_scan_bwd``)."""
    blocks = sum(stack_sizes(cfg).values())
    own = blocks if run.remat and cfg.remat else 0
    return (cfg.hybrid_period - 1) * (block_forwards(cfg, run) + own)


def _cache_shapes(cfg: ArchConfig, run: RunCfg, b: int, t: int) -> dict:
    """This rank's part of the cache (:func:`cache_shapes`), ``b`` its
    rows, ``t`` the whole cache's positions."""
    shapes = cache_shapes(cfg, b, t)
    if run.mesh is None:
        return shapes
    cut = time_cut(cfg, run)
    if cut is not None and t % cut[2]:
        raise ValueError(f"a sequence-sharded cache of {t} positions does not divide "
                         f"over {cut[0]} ({cut[2]} ranks)")
    specs = cache_layout(cfg, run, b, t)
    return {k: s[:2] + SH.local_shape(s[2:], specs[k][2:], run.mesh)
            for k, s in shapes.items()}


def _write_entries(cache: dict, i: int, at: slice, k, v, tp: L.TP) -> None:
    """Write computed ``k``, ``v`` (B, S, ...) into layer ``i`` of
    ``cache`` at positions ``at`` of this rank's slab: their part
    (:func:`repro_torch.models.layers.cache_entry`), quantized where the
    cache is int8.  Where the model axes cut the head_dim, each row's
    max|x| is all-reduced (max) over them first, so that every rank holds
    the whole row's scale (every rank of those axes calls this)."""
    k, v = L.cache_entry(k, tp), L.cache_entry(v, tp)
    if "k_scale" not in cache:
        cache["k"][i, :, at], cache["v"][i, :, at] = k, v
        return
    amax = [KQ.amax(k), KQ.amax(v)]
    if tp.cache_dim == 4:
        amax = C.all_reduce_packed(amax, tp.cache_axes, "max")
    (kq, ks), (vq, vs) = KQ.quantize(k, amax[0]), KQ.quantize(v, amax[1])
    cache["k"][i, :, at], cache["k_scale"][i, :, at] = kq, ks
    cache["v"][i, :, at], cache["v_scale"][i, :, at] = vq, vs


def forward(cfg: ArchConfig, run: RunCfg, params: Transformer, batch, *,
            collect_cache: bool = False, t_max: int = 0, last_only: bool = False):
    """Full-sequence forward over ``batch["tokens"]`` (B, S; on a mesh this
    rank's rows).  Returns (logits, cache|None): the cache holds every
    layer's k and v (:func:`cache_shapes` at T = max(S, t_max); MLA's
    c_kv and k_rope) in the compute dtype, or int8 with their scales
    (``kv_quant``: each layer's entries quantized as they are written),
    zeros past S (JAX's stacked caches concatenated, then ``pad_cache``,
    written in one buffer; on a mesh this rank's part, :func:`cache_layout`,
    with ``seq_shard_kv`` its time slab of the whole prompt's).
    ``last_only`` computes the head on the last position only.  Without a
    cache and with grad enabled, the blocks are rematerialised where
    ``run.remat`` and ``cfg.remat`` are both on (:func:`_scan_blocks`).  On
    a vocab block the logits are this rank's block of the vocab.  RWKV:
    :func:`_rwkv_forward`; Jamba: :func:`_hybrid_forward`."""
    check_supported(cfg, mesh=run.mesh is not None)
    if cfg.mixer == "rwkv":
        return _rwkv_forward(cfg, run, params, batch, collect_cache=collect_cache,
                             last_only=last_only)
    if cfg.mixer == "hybrid":
        return _hybrid_forward(cfg, run, params, batch, collect_cache=collect_cache,
                               t_max=t_max, last_only=last_only)
    cd = _dt(cfg)
    tokens = batch["tokens"]
    top = _top_params(params, cfg, run)
    x = _embed_tokens(top, cfg, run, tokens)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    cache = None
    if collect_cache:
        t = max(s, t_max)
        dtypes = cache_dtypes(cfg)
        cache = {k: torch.zeros(shape, dtype=dtypes[k], device=x.device)
                 for k, shape in _cache_shapes(cfg, run, b, t).items()}
        ctp = attn_tp(cfg, run, cache=True)
        # the prompt's positions in this rank's time slab
        cut = time_cut(cfg, run)
        lo = 0 if cut is None else cut[1] * (t // cut[2])
        hi = min(lo + cache["k"].shape[2], s)
        for i, block in enumerate(_layers(params)):
            x, (k, v) = _uniform_block_fwd(_block_params(block, cfg, run, cd), cfg, run,
                                           x, positions, params.first_expert)
            if hi > lo:
                _write_entries(cache, i, slice(0, hi - lo), k[:, lo:hi], v[:, lo:hi], ctp)
    else:
        def body(block, y):
            return _uniform_block_fwd(_block_params(block, cfg, run, cd), cfg, run, y,
                                      positions, params.first_expert)[0]
        remat = run.remat and cfg.remat and torch.is_grad_enabled()
        for stack in STACKS:
            x = _scan_blocks(getattr(params, stack), x, body, remat)
    if last_only:
        x = x[:, -1:]
    x = _apply_norm(top["final_norm"], x, cfg)
    return _head_out(top, cfg, run, x), cache


def _token_count(run: RunCfg, tokens) -> int:
    """The tokens the loss averages over: this batch's on one device, the
    global batch's (over the data axes) on a mesh."""
    n = tokens.shape[0] * (tokens.shape[1] - 1)
    if run.mesh is None:
        return n
    return n * math.prod(run.mesh.shape[a] for a in run.data_axes if a in run.mesh.shape)


def lm_loss(cfg: ArchConfig, run: RunCfg, params: Transformer, batch):
    """Next-token cross entropy, mean over tokens (``transformer.py:767``):
    the logits cast to f32, ``logsumexp − gold`` for each position but the
    last against the next token.

    On a mesh ``batch`` holds this rank's rows (:func:`local_rows`) and the
    mean is over the global batch of the data axes, the same value on
    every rank; a rank's gradient is its rows' share (FSDP's
    reduce-scatter sums the shares).  On a vocab block the log-softmax is
    distributed: the max and the sum of exponentials all-reduced over the
    model axes, the gold logit taken where it lies."""
    check_supported(cfg, training=True)
    logits, _ = forward(cfg, run, params, batch)
    logits = logits.float()[:, :-1]
    targets = batch["tokens"][:, 1:].long()
    axes, v0, n = _vocab_block(cfg, run)
    if axes:
        m = C.all_reduce(logits.detach().amax(-1), axes, "max")
        sumexp = C.reduce_from(torch.exp(logits - m[..., None]).sum(-1), axes)
        logz = m + torch.log(sumexp)
        local = targets - v0
        mine = (local >= 0) & (local < n)
        gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        gold = C.reduce_from(gold * mine, axes)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    if run.mesh is None:
        return (logz - gold).mean()
    part = (logz - gold).sum() / _token_count(run, batch["tokens"])
    return C.reduce_from(part, run.data_axes)


def init_cache(cfg: ArchConfig, b: int, t_max: int, device="cuda",
               run: RunCfg | None = None):
    """A zero decode cache: the entries of :func:`cache_shapes` at ``t_max``
    (:func:`cache_dtypes`) and ``len`` 0 (on a mesh this rank's part for
    its ``b`` rows)."""
    check_supported(cfg)
    dtypes = cache_dtypes(cfg)
    dev = resolve_device(device)
    out = {k: torch.zeros(shape, dtype=dtypes[k], device=dev)
           for k, shape in _cache_shapes(cfg, run or RunCfg(), b, t_max).items()}
    return dict(out, len=0)


def pad_cache(cfg: ArchConfig, cache, s: int, t_max: int):
    """Pad a prefill cache's time axis (dim 2, whatever the entries' rank:
    5 for GQA, 4 for MLA) to t_max and set len=s: k and v, the int8
    cache's scales too (the reference pads k and v only); RWKV's states
    and Jamba's Mamba states have no time axis."""
    out = dict(cache)
    for key, a in cache.items():
        if key in ("k", "v", "k_scale", "v_scale"):
            out[key] = torch.nn.functional.pad(
                a, (0, 0) * (a.ndim - 3) + (0, t_max - a.shape[2]))
    out["len"] = s
    return out


def _attn_decode(p, cfg: ArchConfig, run: RunCfg, x, ck, cv, clen: int, positions,
                 tp: L.TP):
    """GQA decode of one layer over its cache ``ck``, ``cv`` (this rank's
    part), updated in place (``repro/models/transformer.py:537``).  With
    the cache's time axis cut (:func:`time_cut`): the new entry written
    where this rank's slab holds position ``clen``, each slab attended
    under its ``valid`` mask and the slabs combined over the data axes
    (:func:`repro_torch.models.layers.decode_attention_seqsharded`).  Where
    the model axes cut the head_dim, the partial scores are all-reduced
    over them before the mask and the max, and the output's head_dim
    gathered; where they cut the query heads too, the slabs' head_dim is
    gathered first."""
    a = attn_dims(cfg)
    cut = time_cut(cfg, run)
    if cut is None:
        return L.apply_attention_decode(p, a, x, ck, cv, clen, positions, tp=tp)
    axes, r, count = cut
    q, k, v = L._qkv(p, a, C.copy_to(x, tp.axes), positions)  # s == 1
    b, tl = q.shape[0], ck.shape[1]
    if not 0 <= clen < tl * count:
        raise ValueError(f"cache position {clen} outside its {tl * count} slots")
    start = r * tl
    off = clen - start
    if 0 <= off < tl:
        ck[:, off:off + 1] = L.cache_entry(k, tp).to(ck.dtype)
        cv[:, off:off + 1] = L.cache_entry(v, tp).to(cv.dtype)
    valid = (start + torch.arange(tl, device=q.device) <= clen)[None, :].expand(b, tl)
    if tp.cache_dim == 4 and not tp.axes:
        lo, hi = tp.cache_block
        o = L.decode_attention_seqsharded(q[..., lo:hi], ck, cv, valid, axes,
                                          cut_axes=tp.cache_axes, d_full=a.head_dim)
        o = C.all_gather(o, tp.cache_axes, dim=-1)
    else:
        if tp.cache_dim == 4:  # query heads cut too: the whole head_dim here
            ck, cv = (C.all_gather(c, tp.cache_axes, dim=-1) for c in (ck, cv))
        o = L.decode_attention_seqsharded(q, L._read_kv(ck, tp.kv), L._read_kv(cv, tp.kv),
                                          valid, axes)
    return C.reduce_from(torch.einsum("bshd,hdm->bsm", o, p["wo"]), tp.axes)


def _attn_decode_int8(p, cfg: ArchConfig, run: RunCfg, x, cache: dict, i: int,
                      clen: int, positions, tp: L.TP):
    """GQA decode of layer ``i`` over the int8 cache, updated in place: the
    reference's ``bodyq`` (``repro/models/transformer.py:680–722``) in its
    order.  The layer's whole cache dequantized to the compute dtype, the
    new token's k and v spliced in unquantized at ``clen`` (this token
    attends to its own full-precision entry), the attention under the
    ``valid`` mask over all T, then only the new entry quantized and
    written.  The sequence-sharded decode is never taken (``kv_quant``
    comes first in the reference): a time-cut cache's slabs are gathered
    over the data axes to be read, and the new entry lands in the slab
    that holds ``clen``."""
    a = attn_dims(cfg)
    cd = _dt(cfg)
    q, knew, vnew = L._qkv(p, a, C.copy_to(x, tp.axes), positions)  # s == 1
    names = ("k", "v", "k_scale", "v_scale")
    slabs = [cache[n][i] for n in names]
    cut = time_cut(cfg, run)
    if cut is not None:
        slabs = C.gather_packed(slabs, [1] * len(names), cut[0])
    ck = KQ.dequantize(slabs[0], slabs[2], cd)
    cv = KQ.dequantize(slabs[1], slabs[3], cd)
    t = ck.shape[1]
    if not 0 <= clen < t:
        raise ValueError(f"cache position {clen} outside its {t} slots")
    ck[:, clen:clen + 1] = L.cache_entry(knew, tp).to(cd)
    cv[:, clen:clen + 1] = L.cache_entry(vnew, tp).to(cd)
    out = L.decode_attend(p, a, q, ck, cv, clen, tp)
    tl = cache["k"].shape[2]
    off = clen - (0 if cut is None else cut[1] * tl)
    if 0 <= off < tl:  # the same on every rank of the model axes
        _write_entries(cache, i, slice(off, off + 1), knew, vnew, tp)
    return out


def decode_step(cfg: ArchConfig, run: RunCfg, params: Transformer, cache, tokens):
    """One greedy-decode step. tokens: (B, 1) (on a mesh this rank's
    rows).  Returns (logits, cache); the cache's entries are updated in
    place, ``len`` grows by one.  On a vocab block the logits are this
    rank's block of the vocab.  RWKV: :func:`_rwkv_decode`; Jamba:
    :func:`_hybrid_decode`."""
    check_supported(cfg, mesh=run.mesh is not None)
    if cfg.mixer == "rwkv":
        return _rwkv_decode(cfg, run, params, cache, tokens)
    if cfg.mixer == "hybrid":
        return _hybrid_decode(cfg, run, params, cache, tokens)
    cd = _dt(cfg)
    b = tokens.shape[0]
    clen = int(cache["len"])
    positions = torch.full((b, 1), clen, dtype=torch.long, device=tokens.device)
    top = _top_params(params, cfg, run)
    y = _embed_tokens(top, cfg, run, tokens)
    atp = attn_tp(cfg, run, cache=True)
    for i, block in enumerate(_layers(params)):
        bp = _block_params(block, cfg, run, cd)
        h = _apply_norm(bp["ln1"], y, cfg)
        if cfg.attn_kind == "mla":
            y = y + MLA.apply_mla_decode(bp["attn"], mla_dims(cfg), h, cache["k"][i],
                                         cache["v"][i], clen, positions, tp=atp)
        elif _quantized(cfg):
            y = y + _attn_decode_int8(bp["attn"], cfg, run, h, cache, i, clen, positions,
                                      atp)
        else:
            y = y + _attn_decode(bp["attn"], cfg, run, h, cache["k"][i], cache["v"][i],
                                 clen, positions, atp)
        h = _apply_norm(bp["ln2"], y, cfg)
        y = y + _ff_apply(bp["ff"], cfg, run, h, params.first_expert)
    y = _apply_norm(top["final_norm"], y, cfg)
    return _head_out(top, cfg, run, y), dict(cache, len=clen + 1)


def _rwkv_block_fwd(p, cfg: ArchConfig, run: RunCfg, x, state: dict):
    """One RWKV block over x (B, S, d) from ``state`` (``x_tm``, ``wkv``,
    ``x_cm`` of this layer), as ``_rwkv_block_fwd`` (``transformer.py:262``):
    the time mix after ``ln1``, the channel mix after ``ln2``, each added to
    the residual.  The time axis runs in chunks of at most
    :data:`SEQ_CHUNK_TOKENS` tokens, the state carried from one to the next
    (the same arithmetic as one pass).  Returns (x, the final state)."""
    dims, tp = rwkv_dims(cfg), rwkv_tp(cfg, run)
    b, s = x.shape[:2]
    step = max(1, SEQ_CHUNK_TOKENS // b)
    x_tm, wkv, x_cm = state["x_tm"], state["wkv"], state["x_cm"]
    outs = []
    for c0 in range(0, s, step):
        xc = x[:, c0:c0 + step]
        h = _apply_norm(p["ln1"], xc, cfg)
        y, (x_tm, wkv) = RW.time_mix_seq(p["tm"], dims, h, x_tm, wkv, tp=tp,
                                         plain=run.plain_wkv)
        xc = xc + y
        h = _apply_norm(p["ln2"], xc, cfg)
        y, x_cm = RW.channel_mix_seq(p["cm"], h, x_cm, tp=tp)
        outs.append(xc + y)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out, {"x_tm": x_tm, "wkv": wkv, "x_cm": x_cm}


def _rwkv_forward(cfg: ArchConfig, run: RunCfg, params: Transformer, batch, *,
                  collect_cache: bool, last_only: bool):
    """RWKV's forward (``transformer.py:378``): ``ln0`` after the
    embedding, then each block from a zero state; the cache (this rank's
    part, :func:`cache_layout`) holds each layer's final state.  Without
    a cache the blocks run through :func:`_scan_blocks`, rematerialised
    under autograd where ``run.remat`` and ``cfg.remat`` are both on."""
    cd = _dt(cfg)
    top = _top_params(params, cfg, run)
    x = _apply_norm(top["ln0"], _embed_tokens(top, cfg, run, batch["tokens"]), cfg)
    shapes = _cache_shapes(cfg, run, x.shape[0], 1)
    dtypes = cache_dtypes(cfg)

    def zero():
        return {k: torch.zeros(shape[1:], dtype=dtypes[k], device=x.device)
                for k, shape in shapes.items()}

    cache = None
    if collect_cache:
        cache = {k: torch.empty(shape, dtype=dtypes[k], device=x.device)
                 for k, shape in shapes.items()}
        for i, block in enumerate(_layers(params)):
            x, state = _rwkv_block_fwd(_block_params(block, cfg, run, cd), cfg, run, x,
                                       zero())
            for k, t in state.items():
                cache[k][i] = t
    else:
        def body(block, y):
            return _rwkv_block_fwd(_block_params(block, cfg, run, cd), cfg, run, y,
                                   zero())[0]
        remat = run.remat and cfg.remat and torch.is_grad_enabled()
        for stack in STACKS:
            x = _scan_blocks(getattr(params, stack), x, body, remat)
    if last_only:
        x = x[:, -1:]
    x = _apply_norm(top["final_norm"], x, cfg)
    return _head_out(top, cfg, run, x), cache


def _rwkv_decode(cfg: ArchConfig, run: RunCfg, params: Transformer, cache, tokens):
    """RWKV's decode step (``transformer.py:584``): each layer's time mix
    and channel mix over one token from its state, the recurrence at S = 1;
    the states updated in place (the new ``x_tm`` is ``ln1``'s output)."""
    cd = _dt(cfg)
    dims, tp = rwkv_dims(cfg), rwkv_tp(cfg, run)
    top = _top_params(params, cfg, run)
    y = _apply_norm(top["ln0"], _embed_tokens(top, cfg, run, tokens)[:, 0], cfg)
    for i, block in enumerate(_layers(params)):
        bp = _block_params(block, cfg, run, cd)
        h1 = _apply_norm(bp["ln1"], y, cfg)
        a, wkv = RW.time_mix_step(bp["tm"], dims, h1, cache["x_tm"][i], cache["wkv"][i],
                                  tp=tp, plain=run.plain_wkv)
        y = y + a
        h2 = _apply_norm(bp["ln2"], y, cfg)
        c, x_cm = RW.channel_mix_step(bp["cm"], h2, cache["x_cm"][i], tp=tp)
        y = y + c
        cache["x_tm"][i], cache["wkv"][i], cache["x_cm"][i] = h1, wkv, x_cm
    y = _apply_norm(top["final_norm"], y[:, None], cfg)
    return _head_out(top, cfg, run, y), dict(cache, len=int(cache["len"]) + 1)


def _sub(tree: dict, j: int, dtype: torch.dtype) -> dict:
    """Sub-layer ``j`` of a superblock's stacked leaves (``tree`` as
    :func:`_cast_f` gives it, dtypes kept), floating ones cast to
    ``dtype``."""
    return {k: _sub(v, j, dtype) if isinstance(v, dict)
            else v[j].to(dtype) if v.is_floating_point() else v[j] for k, v in tree.items()}


def _superblock(block: JambaBlock, cfg: ArchConfig, run: RunCfg, x, attend, scan,
                first: int):
    """x through one superblock's sub-layers (``transformer.py:275``): at
    each, RMSNorm ``ln1``, the mixer added, RMSNorm ``ln2``, the
    feed-forward added.  The mixer is ``attend(p, h)`` at
    ``hybrid_attn_pos`` and ``scan(mi, p, h)`` (Mamba layer ``mi``)
    elsewhere, ``p`` its parameters in the compute dtype; the feed-forward
    the MoE at every ``moe.every``-th (its experts from ``first`` on),
    else the dense MLP.  Each sub-layer's
    parameters are cast as it runs (the reference casts the whole
    superblock)."""
    cd, every = _dt(cfg), cfg.moe.every
    ln1, ln2 = block.ln1.to(cd), block.ln2.to(cd)
    mam, moe, mlp = (_cast_f(m, None) for m in (block.mamba, block.moe, block.mlp))
    mi = 0
    for j in range(cfg.hybrid_period):
        h = cm.rms_norm(x, ln1[j])
        if j == cfg.hybrid_attn_pos:
            x = x + attend(_cast_f(block.attn, cd), h)
        else:
            x = x + scan(mi, _sub(mam, mi, cd), h)
            mi += 1
        h = cm.rms_norm(x, ln2[j])
        if j % every == 1 % every:
            x = x + _ff_apply(_sub(moe, j // every, cd), cfg, run, h, first)
        else:
            x = x + L.apply_mlp(_sub(mlp, j // every, cd), h, cfg.mlp_type)
    return x


def _hybrid_forward(cfg: ArchConfig, run: RunCfg, params: Transformer, batch, *,
                    collect_cache: bool, t_max: int, last_only: bool):
    """Jamba's forward (``transformer.py:394``): each superblock's Mamba
    layers from zero states; the cache (:func:`cache_shapes` at T = max(S,
    t_max), zeros past S) holds each superblock's k and v and its Mamba
    layers' final states.  Without a cache, under autograd and where
    ``run.remat`` and ``cfg.remat`` are both on, the reference's training
    structure: the superblocks through :func:`_scan_blocks`, each Mamba
    sub-layer a checkpoint of its own (``mamba_ck``, ``transformer.py:285``),
    so that one Mamba layer's intermediates are live at a time."""
    md = mamba_dims(cfg)
    top = _top_params(params, cfg, run)
    x = _embed_tokens(top, cfg, run, batch["tokens"])
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    shapes, dtypes = cache_shapes(cfg, b, max(s, t_max)), cache_dtypes(cfg)
    zero = {k: torch.zeros(shapes[k][1:], dtype=dtypes[k], device=x.device)
            for k in ("conv", "ssm")}
    cache = None
    if collect_cache:
        cache = {k: torch.zeros(shape, dtype=dtypes[k], device=x.device)
                 for k, shape in shapes.items()}
    remat = cache is None and run.remat and cfg.remat and torch.is_grad_enabled()

    def mamba_out(mi, p, h):
        return MB.mamba_seq(p, md, h, zero["conv"][mi], zero["ssm"][mi],
                            plain=run.plain_scan)[0]

    def superblock(i, block, y):
        def attend(p, h):
            a, (k, v) = L.apply_attention(p, attn_dims(cfg), h, positions,
                                          plain=run.plain_attention)
            if cache is not None:
                cache["k"][i, :, :s], cache["v"][i, :, :s] = k, v
            return a

        def scan(mi, p, h):
            if cache is None:
                return _checkpoint(mamba_out, mi, p, h) if remat else mamba_out(mi, p, h)
            a, (conv, ssm) = MB.mamba_seq(p, md, h, zero["conv"][mi], zero["ssm"][mi],
                                          plain=run.plain_scan)
            cache["conv"][i, mi], cache["ssm"][i, mi] = conv, ssm
            return a

        return _superblock(block, cfg, run, y, attend, scan, params.first_expert)

    if remat:
        for stack in STACKS:
            x = _scan_blocks(getattr(params, stack), x,
                             lambda block, y: superblock(None, block, y), True)
    else:
        for i, block in enumerate(_layers(params)):
            x = superblock(i, block, x)
    if last_only:
        x = x[:, -1:]
    x = _apply_norm(top["final_norm"], x, cfg)
    return _head_out(top, cfg, run, x), cache


def _hybrid_decode(cfg: ArchConfig, run: RunCfg, params: Transformer, cache, tokens):
    """Jamba's decode step (``transformer.py:603``): the attention over its
    cache, each Mamba layer one step from its states (the recurrence at S
    = 1); the cache's entries updated in place."""
    md = mamba_dims(cfg)
    clen = int(cache["len"])
    positions = torch.full((tokens.shape[0], 1), clen, dtype=torch.long,
                           device=tokens.device)
    top = _top_params(params, cfg, run)
    y = _embed_tokens(top, cfg, run, tokens)
    for i, block in enumerate(_layers(params)):
        def attend(p, h, i=i):
            return _attn_decode(p, cfg, run, h, cache["k"][i], cache["v"][i], clen,
                                positions, L.NO_TP)

        def scan(mi, p, h, i=i):
            a, (conv, ssm) = MB.mamba_step(p, md, h[:, 0], cache["conv"][i, mi],
                                           cache["ssm"][i, mi], plain=run.plain_scan)
            cache["conv"][i, mi], cache["ssm"][i, mi] = conv, ssm
            return a[:, None]

        y = _superblock(block, cfg, run, y, attend, scan, params.first_expert)
    y = _apply_norm(top["final_norm"], y, cfg)
    return _head_out(top, cfg, run, y), dict(cache, len=clen + 1)


def prefill(cfg: ArchConfig, run: RunCfg, params: Transformer, batch,
            t_max: int = 0):
    """Forward over the prompt; returns the last position's logits
    (B, 1, vocab) and the cache padded to ``t_max`` with ``len`` = S (an
    RWKV cache has no time axis: ``t_max`` does not matter)."""
    logits, cache = forward(cfg, run, params, batch, collect_cache=True,
                            t_max=t_max, last_only=True)
    cache["len"] = batch["tokens"].shape[1]
    return logits, cache
