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

On a mesh (``RunCfg.mesh``, the ranks of :func:`repro_torch.dist.run_ranks`)
the model holds this rank's shards (:func:`shard_model`, the reference's
specs from :func:`model_axes` and :mod:`repro_torch.distributed.sharding`)
and runs as GSPMD runs the reference: the batch over the data axes; each
block's parameters all-gathered over ``data`` (FSDP) inside the block's
remat region, so the recompute gathers again, their gradients
reduce-scattered back; tensor parallelism over ``model`` where the specs
cut heads, mlp or vocab (:class:`repro_torch.models.layers.TP`): a
vocab-parallel embedding, tied logits on this rank's vocab block and a
distributed log-softmax in :func:`lm_loss`.

Configs outside this path raise ``NotImplementedError`` naming ROADMAP
Queue 1 item 11: MoE, MLA, RWKV, the Jamba hybrid, Whisper's
encoder–decoder, the VLM ``embeds`` input, the int8 KV cache
(``kv_quant``) and the sequence-sharded decode (``seq_shard_kv``).
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
from repro_torch.models import layers as L

LM_ITEM = "ROADMAP Queue 1 item 11"


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
    it is off on the main path and exists to compare the two.  The
    reference's ``seq_shard_kv`` (the sequence-sharded decode) is not
    ported."""
    mesh: SH.Mesh | None = None
    per_pod: bool = False
    plain_attention: bool = False
    remat: bool = True

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
            "port runs the dense uniform decoder")


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

    AXES = {"embed": ("vocab", "embed"), "head": ("embed", "vocab")}

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


def model_axes(cfg: ArchConfig) -> dict:
    """Each parameter's logical axes, ``{port name: axes}``: the
    reference's ``model_axes`` (``transformer.py:216``) under the port's
    names, a block's without the leading ``layers`` axis that JAX stacks
    (:func:`repro_torch.models.convert.axes_to_jax_tree` stacks them)."""
    model = init_model(cfg, device="meta")
    out = {}
    for mname, module in model.named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            out[f"{mname}.{pname}" if mname else pname] = type(module).AXES[pname]
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


def block_specs(cfg: ArchConfig, mesh) -> dict:
    """The specs of a block's parameters, by their names in the block
    (every block has the same)."""
    return _block_specs(cfg, tuple(SH.shape_of(mesh).items()))


@functools.lru_cache(maxsize=None)
def _block_specs(cfg: ArchConfig, mesh_shape: tuple) -> dict:
    return {n[len("blocks.0."):]: s for n, s in _specs(cfg, mesh_shape).items()
            if n.startswith("blocks.0.")}


@torch.no_grad()
def shard_model(model: Transformer, mesh: SH.Mesh) -> Transformer:
    """Replace each parameter of ``model`` (full logical shapes) by this
    rank's shard of it on ``mesh`` (a contiguous copy; the full tensor is
    let go leaf by leaf); returns the model."""
    specs = param_specs(model.cfg, mesh)
    for name, p in list(model.named_parameters()):
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path))
        shard = SH.shard_of(p.data, specs[name], mesh).contiguous()
        setattr(owner, leaf, nn.Parameter(shard, requires_grad=p.requires_grad))
    return model


def _fsdp_gather(named: dict, specs: dict, run: RunCfg) -> dict:
    """``named`` ({name: shard}) with each leaf gathered over the axes of
    its spec other than the model axes (FSDP), one packed exchange an axis
    for leaves cut over the same axes; the model axes' cut stays.  A leaf
    whole on a batch axis is shared over it (:func:`C.copy_to_packed`:
    its gradient, from this rank's rows only, summed there), so that every
    leaf's gradient is the global batch's."""
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
        got = C.gather_packed([named[n] for n, _ in leaves], [d for _, d in leaves],
                              axes)
        out.update({n: g for (n, _), g in zip(leaves, got)})
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


def _block_params(block: nn.Module, cfg: ArchConfig, run: RunCfg, dtype) -> dict:
    """A block's parameters as :func:`_cast_f` gives them; on a mesh
    gathered over the FSDP axes first."""
    if run.mesh is None:
        return _cast_f(block, dtype)
    named = _cast_for_gather(dict(block.named_parameters()), dtype)
    return _nest(_fsdp_gather(named, block_specs(cfg, run.mesh), run), dtype)


def _top_params(params: Transformer, cfg: ArchConfig, run: RunCfg) -> dict:
    """``embed``, ``final_norm`` and ``head`` as a nested dict (their dtype
    kept); on a mesh gathered over the FSDP axes, in one exchange an
    axis, ``embed`` and ``head`` in the compute dtype where no gradient
    flows (their rows and product are cast to it after the gather)."""
    named = {n: p for n, p in params.named_parameters() if not n.startswith("blocks.")}
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
    bs = block_specs(cfg, run.mesh)
    axes = _tp_axes(run, bs["attn.wq"][1])
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
def mlp_tp(cfg: ArchConfig, run: RunCfg) -> L.TP:
    if run.mesh is None:
        return L.NO_TP
    bs = block_specs(cfg, run.mesh)
    name = "ff.wi_gate" if "ff.wi_gate" in bs else "ff.wi"
    return L.TP(axes=_tp_axes(run, bs[name][1]))


def cache_layout(cfg: ArchConfig, run: RunCfg, b: int) -> dict:
    """The decode cache's specs on ``run.mesh`` (the reference's
    ``cache_specs`` for a cache of ``b`` rows)."""
    shape = (cfg.n_layers, b, 1, cfg.n_kv_heads, cfg.head_dim_)
    meta = torch.empty(shape, device="meta")
    return SH.cache_specs(run.mesh, {"k": meta, "v": meta}, cfg)


# ---------------------------------------------------------------------------
# forward (prefill) and decode
# ---------------------------------------------------------------------------


def _uniform_block_fwd(p, cfg: ArchConfig, run: RunCfg, x, positions):
    h = _apply_norm(p["ln1"], x, cfg)
    a, kv = L.apply_attention(p["attn"], attn_dims(cfg), h, positions,
                              plain=run.plain_attention, tp=attn_tp(cfg, run))
    x = x + a
    h = _apply_norm(p["ln2"], x, cfg)
    x = x + L.apply_mlp(p["ff"], h, cfg.mlp_type, tp=mlp_tp(cfg, run))
    return x, kv


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
    data axes (no autograd)."""
    if run.mesh is None:
        return x
    return C.all_gather(x, tuple(a for a in run.data_axes if a in run.mesh.shape), dim=0)


def local_rows(x, run: RunCfg, axes=None):
    """This rank's rows (dim 0) of a global batch tensor: cut over the
    data axes (``batch_spec``), row-major."""
    if run.mesh is None:
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


def _cache_shape(cfg: ArchConfig, run: RunCfg, b: int, t: int) -> tuple:
    """This rank's part of a (L, B, T, Hkv, Dh) cache, ``b`` its rows."""
    shape = (cfg.n_layers, b, t, cfg.n_kv_heads, cfg.head_dim_)
    if run.mesh is None:
        return shape
    spec = cache_layout(cfg, run, b)["k"]
    return shape[:3] + SH.local_shape(shape[3:], spec[3:], run.mesh)


def forward(cfg: ArchConfig, run: RunCfg, params: Transformer, batch, *,
            collect_cache: bool = False, t_max: int = 0, last_only: bool = False):
    """Full-sequence forward over ``batch["tokens"]`` (B, S; on a mesh this
    rank's rows).  Returns (logits, cache|None): the cache holds every
    layer's k and v, ``(L, B, max(S, t_max), Hkv, Dh)`` in the compute
    dtype, zeros past S (JAX's stacked cache then ``pad_cache``, written in
    one buffer; on a mesh this rank's part, :func:`cache_layout`).
    ``last_only`` computes the head on the last position only.  Without a
    cache and with grad enabled, the blocks are rematerialised where
    ``run.remat`` and ``cfg.remat`` are both on (:func:`_scan_blocks`).  On
    a vocab block the logits are this rank's block of the vocab."""
    check_supported(cfg)
    cd = _dt(cfg)
    tokens = batch["tokens"]
    top = _top_params(params, cfg, run)
    x = _embed_tokens(top, cfg, run, tokens)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    cache = None
    if collect_cache:
        shape = _cache_shape(cfg, run, b, max(s, t_max))
        cache = {"k": torch.zeros(shape, dtype=cd, device=x.device),
                 "v": torch.zeros(shape, dtype=cd, device=x.device)}
        ctp = attn_tp(cfg, run, cache=True)
        for i, block in enumerate(params.blocks):
            x, (k, v) = _uniform_block_fwd(_block_params(block, cfg, run, cd), cfg,
                                           run, x, positions)
            cache["k"][i, :, :s] = L.cache_entry(k, ctp)
            cache["v"][i, :, :s] = L.cache_entry(v, ctp)
    else:
        def body(block, y):
            return _uniform_block_fwd(_block_params(block, cfg, run, cd), cfg, run,
                                      y, positions)[0]
        remat = run.remat and cfg.remat and torch.is_grad_enabled()
        x = _scan_blocks(params.blocks, x, body, remat)
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
    """A zero decode cache: k, v (L, B, t_max, Hkv, Dh) and ``len`` 0 (on
    a mesh this rank's part for its ``b`` rows)."""
    check_supported(cfg)
    cd = _dt(cfg)
    shape = _cache_shape(cfg, run or RunCfg(), b, t_max)
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
    """One greedy-decode step. tokens: (B, 1) (on a mesh this rank's
    rows).  Returns (logits, cache); the cache's k and v are updated in
    place, ``len`` grows by one.  On a vocab block the logits are this
    rank's block of the vocab."""
    check_supported(cfg)
    cd = _dt(cfg)
    b = tokens.shape[0]
    clen = int(cache["len"])
    positions = torch.full((b, 1), clen, dtype=torch.long, device=tokens.device)
    top = _top_params(params, cfg, run)
    y = _embed_tokens(top, cfg, run, tokens)
    a_dims = attn_dims(cfg)
    atp, ftp = attn_tp(cfg, run, cache=True), mlp_tp(cfg, run)
    for i, block in enumerate(params.blocks):
        bp = _block_params(block, cfg, run, cd)
        h = _apply_norm(bp["ln1"], y, cfg)
        y = y + L.apply_attention_decode(bp["attn"], a_dims, h, cache["k"][i],
                                         cache["v"][i], clen, positions, tp=atp)
        h = _apply_norm(bp["ln2"], y, cfg)
        y = y + L.apply_mlp(bp["ff"], h, cfg.mlp_type, tp=ftp)
    y = _apply_norm(top["final_norm"], y, cfg)
    return _head_out(top, cfg, run, y), {"k": cache["k"], "v": cache["v"],
                                         "len": clen + 1}


def prefill(cfg: ArchConfig, run: RunCfg, params: Transformer, batch,
            t_max: int = 0):
    """Forward over the prompt; returns the last position's logits
    (B, 1, vocab) and the cache padded to ``t_max`` with ``len`` = S."""
    logits, cache = forward(cfg, run, params, batch, collect_cache=True,
                            t_max=t_max, last_only=True)
    cache["len"] = batch["tokens"].shape[1]
    return logits, cache
