"""Logical-axis → mesh-axis sharding rules (MaxText-style), and the
shards they cut.

Port of ``repro.distributed.sharding``.  Params carry logical axis names
(:func:`repro_torch.models.transformer.model_axes`); this module turns them
into specs with the reference's two safeguards:

* a mesh axis is used at most once per spec (first logical axis wins);
* a dim must divide evenly by the mesh-axis size, else it falls back to
  replication (e.g. smollm's 15 heads on a 2-way model axis).

A spec is a plain tuple, one entry a dim: ``None`` (replicated), an axis
name, or a tuple of axis names (the dim cut over all of them, row-major),
where the reference has a ``PartitionSpec``.  A mesh is anything with a
``shape`` mapping of axis name to size (the reference's ``Mesh``, the
port's :class:`Mesh`) or that mapping itself.

DP over (pod, data); FSDP = params' ``embed`` dim over ``data``; TP over
``model`` (heads / mlp / vocab).  GSPMD cuts the shards and places the
collectives in the reference; here :func:`local_shape` and
:func:`shard_of` cut them, and :mod:`repro_torch.distributed.collectives`
moves them.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

# logical axis -> preferred mesh axes (tuple entries mean "all of these")
PARAM_RULES = {
    "embed": ("data",),          # FSDP / ZeRO-3 param sharding
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "heads_x": ("model",),       # rwkv fused-head projections
    "mlp": ("model",),
    "expert_mlp": None,
    "experts": ("model",),       # expert parallelism
    "kv_lora": None,
    "embed_out": ("model",),
    "head_dim": None, "layers": None, "sub": None, "seq": None,
    "five": None, "two": None, "conv": None, "state": None, "lora": None,
}

ACT_RULES = {
    "batch": ("data",),
    "seq": None, "embed": None, "heads": ("model",), "kv_heads": ("model",),
    "mlp": ("model",), "experts": ("model",), "head_dim": None,
    "vocab": ("model",),
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh as a rank sees it: ``shape`` maps each axis name to its size
    (in mesh order, outermost first) and ``coords`` each axis to this
    rank's coordinate on it."""
    shape: dict
    coords: dict

    def __hash__(self):  # a RunCfg holding it keys cached layouts
        return hash((tuple(self.shape.items()), tuple(self.coords.items())))


def mesh_axes(mesh) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(data_axes incl. pod, model_axes) for a production-style mesh (a
    :class:`Mesh`, or its axis names)."""
    names = tuple(mesh.shape if hasattr(mesh, "shape") else mesh)
    return tuple(a for a in ("pod", "data") if a in names), ("model",)


def mesh_coords(rank: int, sizes: Mapping) -> dict:
    """Coordinates of ``rank`` on a mesh of ``sizes`` ({axis: size}, in
    order), row-major as :func:`repro_torch.dist.coords_of`."""
    out = {}
    for axis in reversed(list(sizes)):
        rank, out[axis] = divmod(rank, int(sizes[axis]))
    return {a: out[a] for a in sizes}


def shape_of(mesh) -> Mapping:
    """``{axis: size}`` of a mesh (anything with a ``shape`` mapping, or
    the mapping itself)."""
    return mesh if isinstance(mesh, Mapping) else mesh.shape


def multipod_rules(rules):
    """Extend DP/FSDP axes with the pod axis: batch over (pod, data)."""
    out = dict(rules)
    if "batch" in out:
        out["batch"] = ("pod", "data")
    return out


def _axes_size(shape: Mapping, axes) -> int:
    return math.prod(shape[a] for a in axes)


def spec_for(mesh, logical: tuple, shape: tuple, rules) -> tuple:
    """The spec of one param given its logical axes and shape."""
    mshape = shape_of(mesh)
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical):
        rule = rules.get(name)
        if rule is None:
            parts.append(None)
            continue
        rule = tuple(a for a in rule if a in mshape and a not in used)
        if not rule or dim % _axes_size(mshape, rule) != 0:
            parts.append(None)
            continue
        used.update(rule)
        parts.append(rule if len(rule) > 1 else rule[0])
    return tuple(parts)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def tree_specs(mesh, axes_tree, shapes_tree, rules=None):
    """Specs mirroring ``axes_tree`` (nested dicts whose leaves are tuples
    of logical axes); ``shapes_tree`` has the same structure, its leaves
    anything with a ``shape``."""
    rules = rules or PARAM_RULES
    if _is_axes(axes_tree):
        return spec_for(mesh, axes_tree, tuple(shapes_tree.shape), rules)
    return {k: tree_specs(mesh, v, shapes_tree[k], rules) for k, v in axes_tree.items()}


def batch_spec(mesh, ndim: int, rules=None) -> tuple:
    """Batch-leading activation spec: (batch, ...replicated)."""
    rules = rules or ACT_RULES
    mshape = shape_of(mesh)
    b = tuple(a for a in rules.get("batch", ()) if a in mshape)
    lead = b if len(b) > 1 else (b[0] if b else None)
    return (lead,) + (None,) * (ndim - 1)


def cache_batch_axes(mesh, rules=None) -> tuple:
    """The mesh axes :func:`cache_specs` cuts a cache's batch over (or,
    with ``seq_shard``, its time axis), in order."""
    rules = rules or ACT_RULES
    return tuple(a for a in rules.get("batch", ("data",)) if a in shape_of(mesh))


def cache_specs(mesh, cache_shapes, cfg, *, seq_shard: bool = False, rules=None):
    """Decode-cache specs: batch over (pod, data), kv heads over model if
    divisible, else head_dim over model if that divides (the reference's
    fallback: replicating a long cache costs its size again on every model
    rank); ``seq_shard`` (long_500k) shards the time axis over data.
    ``cache_shapes`` maps each cache entry to anything with a ``shape`` (or
    to a non-array, e.g. ``len``)."""
    rules = rules or ACT_RULES
    mshape = shape_of(mesh)
    b_axes = cache_batch_axes(mesh, rules)
    b_lead = b_axes if len(b_axes) > 1 else (b_axes[0] if b_axes else None)

    def one(name, sh):
        if name == "len" or len(sh) == 0:
            return ()
        if name in ("k", "v", "xk", "xv", "k_scale", "v_scale"):  # (L,B,T,[H,]D)
            parts = [None] * len(sh)
            if seq_shard:
                if b_axes and sh[2] % _axes_size(mshape, b_axes) == 0:
                    parts[2] = b_lead
            elif b_lead is not None and sh[1] % _axes_size(mshape, b_axes) == 0:
                parts[1] = b_lead
            if len(sh) >= 5 and "model" in mshape:
                if sh[3] % mshape["model"] == 0:
                    parts[3] = "model"
                elif sh[4] % mshape["model"] == 0:
                    parts[4] = "model"
            return tuple(parts)
        # states (rwkv/mamba): (L, B, ...) or (L, sub, B, ...)
        parts = [None] * len(sh)
        bdim = 1 if name in ("x_tm", "wkv", "x_cm") else 2
        if b_lead is not None and len(sh) > bdim and sh[bdim] % _axes_size(mshape, b_axes) == 0:
            parts[bdim] = b_lead
        return tuple(parts)

    return {k: (one(k, tuple(v.shape)) if hasattr(v, "shape") else ())
            for k, v in cache_shapes.items()}


# ---------------------------------------------------------------------------
# what GSPMD hides: the shards themselves
# ---------------------------------------------------------------------------


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry (``None``, an axis, or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> tuple:
    """Every mesh axis a spec cuts along, in the spec's order."""
    return tuple(a for e in spec for a in entry_axes(e))


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's shard of a tensor of ``shape``."""
    mshape = shape_of(mesh)
    return tuple(n // _axes_size(mshape, entry_axes(e)) for n, e in
                 zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


def shard_index(entry, mesh) -> tuple[int, int]:
    """``(index, count)`` of this rank's block along a dim cut by
    ``entry``: its coordinates on the entry's axes, row-major."""
    idx, count = 0, 1
    for a in entry_axes(entry):
        idx = idx * mesh.shape[a] + mesh.coords[a]
        count *= mesh.shape[a]
    return idx, count


def shard_of(full, spec, mesh):
    """This rank's shard of ``full`` (a tensor or a numpy array of the
    full logical shape), a view where the array allows one: each dim cut
    along its spec entry's axes at ``mesh.coords`` (a :class:`Mesh`)."""
    out = full
    for dim, entry in enumerate(spec):
        idx, count = shard_index(entry, mesh)
        if count == 1:
            continue
        size = full.shape[dim] // count
        sl = [slice(None)] * len(full.shape)
        sl[dim] = slice(idx * size, (idx + 1) * size)
        out = out[tuple(sl)]
    return out
