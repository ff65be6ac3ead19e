"""AdamW with global-norm clipping, a cosine schedule and dtype-configurable
moments.

Port of ``repro.optim.adamw`` with its arithmetic, op for op in f32: the
gradients' global norm, a clip factor ``min(1, clip_norm / max(norm,
1e-9))``, the schedule at the incremented count, bias corrections
``1 − b**count``, ``eps`` outside the square root, weight decay on every
leaf, and the moments kept in ``moment_dtype`` (computed in f32).  It is
not ``torch.optim.AdamW``, whose clip, schedule and order of operations
differ.

The trees are flat ``{name: tensor}`` mappings (the model's
``named_parameters()``); :func:`update` changes the parameters and the
moments in place under ``torch.no_grad()``, each step of the arithmetic a
``torch._foreach_*`` call over all the leaves.

On a mesh the leaves are this rank's shards (the moments sharded like
their parameters, the update elementwise on them) and :func:`global_norm`
is the norm of the whole tree: given the mesh axes each leaf's spec cuts,
the local sums of squares of the leaves cut over the same axes are
all-reduced over those axes (one packed exchange an axis), so that a
leaf whole on some axes is counted once, not once a rank.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import collectives as C


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _moment_dtype(c: AdamWConfig) -> torch.dtype:
    if c.moment_dtype not in _DTYPES:
        raise ValueError(f"moment_dtype {c.moment_dtype!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[c.moment_dtype]


def schedule(c: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), f32: linear
    warmup, then a cosine down to ``min_lr_ratio · lr``."""
    if isinstance(step, torch.Tensor):
        step = step.to(torch.float32)
    else:
        step = torch.tensor(float(step), dtype=torch.float32)
    warm = torch.clamp(step / max(c.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - c.warmup_steps)
                    / max(c.total_steps - c.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return c.lr * warm * (c.min_lr_ratio + (1 - c.min_lr_ratio) * cos)


def init(c: AdamWConfig, params: dict) -> dict:
    """Zero moments beside each parameter, in ``moment_dtype``, and an
    int32 ``count`` of 0 on the parameters' device."""
    dt = _moment_dtype(c)
    dev = next(iter(params.values())).device
    return {"m": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for n, p in params.items()},
            "v": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(leaves, cut_axes=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, f32
    (each leaf's through ``torch._foreach_norm``, squared).  ``cut_axes``
    (one tuple of mesh axes a leaf, or None on one device) names the axes
    each leaf is a shard over: those leaves' squares are summed over the
    ranks of those axes before the total."""
    norms = torch._foreach_norm([g.to(torch.float32) for g in leaves])
    sq = torch.stack(norms).square()
    if cut_axes is None:
        return sq.sum().sqrt()
    groups: dict = {}
    for i, axes in enumerate(cut_axes):
        groups.setdefault(tuple(axes), []).append(i)
    parts = []
    for axes, idx in groups.items():
        sel = sq[torch.tensor(idx, device=sq.device)]
        parts.append(C.all_reduce(sel, axes, "sum") if axes else sel)
    return torch.cat(parts).sum().sqrt()


def _f32(xs: list) -> list:
    """Each tensor as f32: itself where it is f32 already."""
    return [x if x.dtype == torch.float32 else x.to(torch.float32) for x in xs]


def _store(dst: list, src: list) -> None:
    """Copy (cast) each of ``src`` into ``dst`` where they are not the
    same tensor."""
    pairs = [(d, s) for d, s in zip(dst, src) if d is not s]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


@torch.no_grad()
def update(c: AdamWConfig, grads: dict, state: dict, params: dict,
           cut_axes: dict | None = None):
    """One step in place: ``params`` and ``state["m"]``, ``state["v"]``
    are updated where they lie and ``state["count"]`` is replaced by the
    incremented count.  Returns ``(params, state, metrics)``, metrics
    ``grad_norm`` and ``lr`` (0-dim f32 tensors), as the reference's.
    ``cut_axes`` ({name: mesh axes}) makes the leaves shards
    (:func:`global_norm`)."""
    names = list(params)
    ps = [params[n] for n in names]
    gs = [grads[n] for n in names]
    ms = [state["m"][n] for n in names]
    vs = [state["v"][n] for n in names]
    count = state["count"] + 1
    gnorm = global_norm(gs, None if cut_axes is None else [cut_axes[n] for n in names])
    scale = torch.clamp(c.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(c, count)
    b1, b2 = c.b1, c.b2
    cf = count.to(torch.float32)
    bc1 = 1 - torch.pow(b1, cf)
    bc2 = 1 - torch.pow(b2, cf)

    g32 = torch._foreach_mul(_f32(gs), scale)
    m32 = _f32(ms)                         # m ← b1·m + (1 − b1)·g
    torch._foreach_mul_(m32, b1)
    torch._foreach_add_(m32, torch._foreach_mul(g32, 1 - b1))
    v32 = _f32(vs)                         # v ← b2·v + (1 − b2)·g·g
    torch._foreach_mul_(v32, b2)
    gg = torch._foreach_mul(g32, 1 - b2)
    torch._foreach_mul_(gg, g32)
    torch._foreach_add_(v32, gg)
    del g32, gg
    step = torch._foreach_div(m32, bc1)    # (m/bc1) / (sqrt(v/bc2) + eps)
    den = torch._foreach_div(v32, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, c.eps)
    torch._foreach_div_(step, den)
    del den
    p32 = _f32(ps)
    torch._foreach_add_(step, torch._foreach_mul(p32, c.weight_decay))
    torch._foreach_mul_(step, lr)          # p ← p − lr·step
    torch._foreach_sub_(p32, step)
    _store(ps, p32)
    _store(ms, m32)
    _store(vs, v32)
    new_state = dict(state, count=count)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
