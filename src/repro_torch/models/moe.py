"""Token-choice top-k Mixture of Experts with capacity-based dispatch.

Port of ``repro.models.moe``.  The parameters are the JAX tree's:
``router`` (D, E), ``experts.wi_gate`` / ``experts.wi_up`` (E, D, F),
``experts.wo`` (E, F, D) and, with shared experts, ``shared`` (an MLP).

The routing is the reference's, term for term: the router product in the
compute dtype, then softmax in f32 and top-k (the lower expert index first
among equal probabilities, as ``jax.lax.top_k``: a stable descending sort,
since ``torch.topk`` promises no order among equals), the top-k
renormalised where ``router_norm_topk``; each (token, slot) pair's
arrival position in its expert's buffer is the count of earlier pairs of
the flattened (token, slot) rows routed to the same expert, and a pair
whose position reaches the capacity is dropped.

:func:`apply_moe` computes by index where the reference multiplies by a
one-hot (T, k, E, cap) dispatch tensor (43 GB in bf16 at a prefill of
16384 tokens): each kept pair's token row is gathered into an (E, cap, D)
buffer at ``e·cap + pos``, the three expert products run as batched
matmuls, and the rows are gathered back weighted by their top-k
probabilities.  :func:`apply_moe_plain`, the reference's one-hot formula,
is the plain version that tests hold it against; nothing on the main path
calls it.

The expert-parallel path (:func:`moe_ep_local`, :func:`apply_moe_ep`) is
the paper's fold communication: the tokens lie over the data axes, the
experts over the model axes, and the dispatch and the combine are each
one capacity-bounded all-to-all over the model axes
(:func:`repro_torch.distributed.collectives.all_to_all`: on the card the
peer-mapped wire, ``ring_send``/``ring_land``), the tokens cut into
``chunks`` slabs (§4.3.2's pipelined schedule), each rematerialised
under autograd as ``jax.checkpoint`` does.

``drops``, when set to ``{"pairs": 0, "dropped": 0}``, counts the
(token, slot) pairs routed and those dropped by every call of either path
(device tensors, added without a synchronisation; a rematerialised call
counts again, both terms alike; :func:`count_drops`).  ``routing`` pins the expert choices of
one run to another's, for comparisons: the top-k of bf16 router logits
flips under a one-unit change of its input, so two runs that round
differently (the flash kernel against its plain version, 2x2 against one
device) route some tokens to other experts.  ``{"record": []}`` keeps each
:func:`apply_moe` call's choices (B, S, k), in call order, on one device;
``{"replay": [...], "at": 0, "flips": 0, "tokens": 0}`` makes each MoE
call of the model (:func:`repro_torch.models.transformer._ff_apply`, no
autograd) take the next one's choices in place of its own top-k (the
weights its own probabilities at those experts), counting the tokens
whose own choice differs.  Both are None, doing nothing, unless a caller
sets them.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L

drops = None
routing = None


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0           # deepseek shared experts
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    mlp_type: str = "swiglu"
    router_norm_topk: bool = True   # qwen3 renormalizes the top-k probs


class Experts(nn.Module):
    """``init_moe``'s ``experts``: one gated MLP an expert, stacked on a
    leading expert axis; ``count`` of them (None: all)."""

    AXES = {"wi_gate": ("experts", "embed", "expert_mlp"),
            "wi_up": ("experts", "embed", "expert_mlp"),
            "wo": ("experts", "expert_mlp", "embed")}

    def __init__(self, ini, m: MoEDims, count: int | None = None):
        super().__init__()
        e = m.n_experts if count is None else count
        self.wi_gate = ini.param((e, m.d_model, m.d_ff_expert))
        self.wi_up = ini.param((e, m.d_model, m.d_ff_expert))
        self.wo = ini.param((e, m.d_ff_expert, m.d_model))


class MoE(nn.Module):
    """``init_moe``: the router, the experts and the shared MLP.  ``held``
    (first, count) makes only that block of the experts (one card's share
    of an expert-parallel deployment, :func:`apply_moe`'s ``first``), the
    router whole; None makes them all."""

    AXES = {"router": ("embed", "experts")}

    def __init__(self, ini, m: MoEDims, held: tuple | None = None):
        super().__init__()
        if held is not None and not (0 <= held[0] and held[1] >= 1
                                     and held[0] + held[1] <= m.n_experts):
            raise ValueError(f"held experts {held}: a block (first, count) of "
                             f"{m.n_experts}")
        self.router = ini.param((m.d_model, m.n_experts), scale=0.02)
        self.experts = Experts(ini, m, None if held is None else held[1])
        if m.n_shared:
            self.shared = L.MLP(ini, m.d_model, m.d_ff_shared or m.d_ff_expert * m.n_shared,
                                m.mlp_type)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _capacity(m: MoEDims, n_tokens: int) -> int:
    cap = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, min(cap, n_tokens))


def ep_capacity(m: MoEDims, n_tokens: int) -> int:
    """The expert-parallel path's capacity a (sender, expert) pair: the
    sender's tokens times ``k · capacity_factor / E`` rounded up, then up
    to a multiple of 4, at least 4 (``moe.py:140``)."""
    cap = int(math.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_experts))
    return max(4, ((cap + 3) // 4) * 4)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values and
    their indices, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(xt: torch.Tensor, router: torch.Tensor, m: MoEDims, pinned=None):
    """(top_p, top_e), each (T, k): the router's top-k probabilities (f32,
    renormalised where ``router_norm_topk``) and experts of each token;
    ``pinned`` (T, k) replaces the top-k experts (``routing``)."""
    probs = torch.softmax((xt @ router).float(), dim=-1)
    top_p, top_e = top_k(probs, m.top_k)
    if pinned is not None:
        if routing is not None and "flips" in routing:
            own, want = torch.sort(top_e, -1).values, torch.sort(pinned, -1).values
            routing["flips"] = routing["flips"] + (own != want).any(-1).sum()
            routing["tokens"] += top_e.shape[0]
        top_e, top_p = pinned, probs.gather(-1, pinned)
    if m.router_norm_topk:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_e


def arrival(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each entry's position among the entries before it routed to the
    same expert (the reference's ``cumsum(one_hot) - one_hot``, by a
    stable sort)."""
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    ranked = torch.arange(flat_e.numel(), device=flat_e.device) - starts[flat_e[order]]
    pos = torch.empty_like(ranked)
    pos[order] = ranked
    return pos


def next_pinned():
    """The next recorded expert choices to replay (``routing``), or None."""
    if routing is None or "replay" not in routing:
        return None
    routing["at"] += 1
    return routing["replay"][routing["at"] - 1]


def _note(keep: torch.Tensor) -> None:
    if drops is not None:
        drops["pairs"] += keep.numel()
        drops["dropped"] = drops["dropped"] + (~keep).sum()


def _gather_rows(xt: torch.Tensor, slot: torch.Tensor, rows: int, k: int) -> torch.Tensor:
    """An (rows, D) buffer of ``xt``'s token rows: row ``slot[i]`` holds the
    token of pair i (token ``i // k``); rows no pair fills are zero.
    ``slot`` is ``rows`` for a dropped pair (the overflow row, cut off)."""
    t, d = xt.shape
    src = torch.full((rows + 1,), t, dtype=torch.long, device=xt.device)
    src[slot] = torch.arange(slot.numel(), device=xt.device) // k
    return torch.cat([xt, xt.new_zeros(1, d)])[src[:-1]]


def _combine(ye: torch.Tensor, slot: torch.Tensor, weight: torch.Tensor, t: int,
             k: int) -> torch.Tensor:
    """(T, D): each token's rows of ``ye`` (rows, D) at its pairs' slots
    times their weights, summed over its k pairs.  A dropped pair (slot
    past the end, weight 0) reads the last row, times 0."""
    rows = ye[slot.clamp(max=ye.shape[0] - 1)]
    return (rows * weight.to(ye.dtype)[:, None]).reshape(t, k, -1).sum(1)


def _ffn(xe: torch.Tensor, w: dict, act) -> torch.Tensor:
    """The experts' gated MLP on their buffers: xe (E', c, D) → (E', c, D)."""
    h = act(torch.bmm(xe, w["wi_gate"])) * torch.bmm(xe, w["wi_up"])
    return torch.bmm(h, w["wo"])


def _gelu(v):
    return F.gelu(v, approximate="tanh")


# ---------------------------------------------------------------------------
# one group of tokens, all experts (or this rank's block of them)
# ---------------------------------------------------------------------------


def apply_moe(p: dict, m: MoEDims, x: torch.Tensor, *, first: int = 0,
              shared: bool = True, pinned=None) -> torch.Tensor:
    """x: (B, S, D) → (B, S, D), capacity-dropped token-choice routing
    (``moe.py:61``), computed by index.  ``p["experts"]`` may hold a
    block of the experts, ``first`` its first: the result is then the
    share of the output of the pairs routed to them (routing, capacity
    and arrival order those of all E experts), which summed over the
    blocks is the whole; ``shared=False`` leaves the shared MLP to the
    caller; ``pinned`` (T, k) replaces the top-k experts."""
    b, s, d = x.shape
    t, k = b * s, m.top_k
    xt = x.reshape(t, d)
    cap = _capacity(m, t)
    top_p, top_e = route(xt, p["router"], m, pinned)
    if pinned is None and routing is not None and "record" in routing:
        routing["record"].append(top_e.reshape(b, s, k))
    flat_e = top_e.reshape(-1)
    pos = arrival(flat_e, m.n_experts)
    n = p["experts"]["wi_gate"].shape[0]
    keep = pos < cap
    _note(keep)
    mine = keep & (flat_e >= first) & (flat_e < first + n)
    slot = torch.where(mine, (flat_e - first) * cap + pos, n * cap)
    xe = _gather_rows(xt, slot, n * cap, k).reshape(n, cap, d)
    ye = _ffn(xe, p["experts"], F.silu).reshape(n * cap, d)
    out = _combine(ye, slot, torch.where(mine, top_p.reshape(-1), 0.0), t, k)
    if shared and "shared" in p:
        out = out + L.apply_mlp(p["shared"], xt, m.mlp_type)
    return out.reshape(b, s, d)


def apply_moe_plain(p: dict, m: MoEDims, x: torch.Tensor) -> torch.Tensor:
    """:func:`apply_moe` by the reference's formula: the one-hot (T, k, E,
    cap) dispatch and combine tensors and einsums (``moe.py:61–99``).
    The plain version, at sizes where that tensor fits."""
    b, s, d = x.shape
    t, e = b * s, m.n_experts
    xt = x.reshape(t, d)
    cap = _capacity(m, t)
    top_p, top_e = route(xt, p["router"], m)
    onehot = F.one_hot(top_e, e).to(torch.int32)                    # (T, k, E)
    flat = onehot.reshape(t * m.top_k, e)
    pos = torch.cumsum(flat, 0) - flat
    pos = torch.sum(pos * flat, -1).reshape(t, m.top_k)
    keep = pos < cap
    disp = (F.one_hot(top_e, e).to(xt.dtype)[..., None]
            * F.one_hot(torch.where(keep, pos, cap).long(), cap + 1)
            .to(xt.dtype)[..., None, :-1])                          # (T, k, E, cap)
    combine = (disp * top_p.to(xt.dtype)[..., None, None]).sum(1)
    disp = disp.sum(1)
    xe = torch.einsum("td,tec->ecd", xt, disp)
    w = p["experts"]
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, w["wi_gate"])) \
        * torch.einsum("ecd,edf->ecf", xe, w["wi_up"])
    ye = torch.einsum("ecf,efd->ecd", h, w["wo"])
    out = torch.einsum("ecd,tec->td", ye, combine)
    if "shared" in p:
        out = out + L.apply_mlp(p["shared"], xt, m.mlp_type)
    return out.reshape(b, s, d)


def count_drops(fn):
    """``fn()`` with ``drops`` counting: (its result, the share of the
    pairs routed in it that were dropped)."""
    global drops
    drops = {"pairs": 0, "dropped": 0}
    try:
        out = fn()
        return out, float(drops["dropped"]) / max(drops["pairs"], 1)
    finally:
        drops = None


# ---------------------------------------------------------------------------
# expert parallelism: the fold communication over the model axes
# ---------------------------------------------------------------------------


def _live_size(axes) -> int:
    return math.prod(C.axis_size(a) for a in axes)


def moe_ep_local(xt: torch.Tensor, p: dict, m: MoEDims, model_axes: tuple,
                 pinned=None) -> torch.Tensor:
    """Inside a rank of the mesh: ``xt`` (T_loc, D) its tokens, ``p["router"]``
    whole, ``p["experts"]`` its E/msize experts (the block of its model
    coordinate).  Returns (T_loc, D) (``moe.py:115``).

    Each sender routes its tokens with a fixed capacity a (sender, expert)
    pair (:func:`ep_capacity`), gathers them into an (E·cap, D) buffer of
    static expert slabs, and sends each rank its experts' slabs in one
    all-to-all; the experts run on (E_loc, msize·cap, D), and the mirror
    all-to-all brings every row back to its sender.  ``pinned`` (T_loc, k)
    replaces the top-k experts."""
    t, d = xt.shape
    msize = _live_size(model_axes)
    e, k = m.n_experts, m.top_k
    e_loc = e // msize
    top_p, top_e = route(xt, p["router"], m, pinned)
    flat_e = top_e.reshape(-1)
    cap = ep_capacity(m, t)
    pos = arrival(flat_e, e)
    keep = pos < cap
    _note(keep)
    slot = torch.where(keep, flat_e * cap + pos, e * cap)
    send_x = _gather_rows(xt, slot, e * cap, k)                     # (E·cap, D)
    # the fold: block j (the experts of model rank j) to rank j
    recv = C.all_to_all(send_x, model_axes)
    xe = recv.reshape(msize, e_loc, cap, d).transpose(0, 1).reshape(e_loc, msize * cap, d)
    act = F.silu if m.mlp_type == "swiglu" else _gelu
    ye = _ffn(xe, p["experts"], act)
    ye = ye.reshape(e_loc, msize, cap, d).transpose(0, 1).reshape(msize * e_loc * cap, d)
    back = C.all_to_all(ye, model_axes)
    return _combine(back, slot, torch.where(keep, top_p.reshape(-1), 0.0), t, k)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def apply_moe_ep(p: dict, m: MoEDims, x: torch.Tensor, *, model_axes=("model",),
                 chunks: int = 1, shared_tp=L.NO_TP, pinned=None) -> torch.Tensor:
    """The expert-parallel MoE (``moe.py:176``) on this rank: ``x`` (B_loc,
    S, D) its rows of the batch, the same on every rank of ``model_axes``;
    ``p["router"]`` whole, ``p["experts"]`` this rank's block of them.
    The tokens run in ``chunks`` slabs (shrunk until they divide the
    local tokens), each checkpointed under autograd.

    Every rank of a model group routes the same tokens and sends them all,
    so each expert gets ``msize`` copies of a token; each rank keeps its
    own copy's output.  The gradients follow the reference's
    ``shard_map`` transpose: the output's gradient is divided by
    ``msize`` (the copies' sum is then the expert's gradient) and the
    input's summed over the model axes (:func:`C.copy_to`); the router's,
    a share on each rank, is summed by the caller's gather over the model
    axes.  ``pinned`` (B_loc·S, k) replaces the top-k experts."""
    b, s, d = x.shape
    axes = tuple(model_axes)
    xt = C.copy_to(x.reshape(-1, d), axes)
    tl = xt.shape[0]
    c = min(chunks, tl)
    while tl % c:
        c -= 1
    step = tl // c

    def one(ct, i):
        return moe_ep_local(ct, p, m, axes,
                            None if pinned is None else pinned[i * step:(i + 1) * step])

    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xt, p["router"], *p["experts"].values()))
    outs = [torch.utils.checkpoint.checkpoint(one, xt[i * step:(i + 1) * step], i,
                                              use_reentrant=False)
            if remat else one(xt[i * step:(i + 1) * step], i) for i in range(c)]
    out = torch.cat(outs).reshape(b, s, d)
    msize = _live_size(axes)
    if msize > 1 and out.requires_grad:
        out = _ScaleGrad.apply(out, 1.0 / msize)
    if "shared" in p:
        out = out + L.apply_mlp(p["shared"], x, m.mlp_type, tp=shared_tp)
    return out


def load_balance_loss(gate_logits: torch.Tensor, top_e: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss (fraction · prob per expert,
    ``moe.py:215``)."""
    probs = torch.softmax(gate_logits.float(), dim=-1)
    frac = F.one_hot(top_e[..., 0], n_experts).float().mean(0)
    imp = probs.mean(0)
    return n_experts * torch.sum(frac * imp)
