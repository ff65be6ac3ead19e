"""Carry the JAX package's parameters into the port.

The JAX params are a nested dict of arrays whose ``blocks`` leaves carry a
leading layer axis L.  :func:`params_from_jax` takes them as numpy arrays
(``jax.tree.map(np.asarray, params)``; nothing here imports JAX), unstacks
``blocks`` into the port's per-layer modules and keeps every other layout
as it is (``wq`` (d, H, Dh), ``wo`` (H, Dh, d), ...), so that the port's
einsums match the JAX ones term for term.  :func:`params_to_jax_tree` is
its inverse: the JAX tree of any ``{port name: tensor}`` mapping (the
parameters, or an optimizer moment beside them), the layout in which the
trainer writes checkpoints, so that either package resumes the other's
training.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer, init_model, shard_model


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def port_leaves(tree) -> dict:
    """The JAX pytree's leaves under the port's parameter names:
    ``blocks.<path>`` with leading axis L becomes ``blocks.<i>.<path>``."""
    out = {}
    for name, leaf in _flatten(tree):
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            for i in range(leaf.shape[0]):
                out[f"blocks.{i}.{rest}"] = leaf[i]
        else:
            out[name] = leaf
    return out


def params_from_jax(cfg: ArchConfig, tree, device="cuda") -> Transformer:
    """The port's model on ``device`` holding the JAX params ``tree``;
    raises when a name or a shape does not match."""
    dev = resolve_device(device)
    model = init_model(cfg, device="meta").to_empty(device=dev)
    leaves = port_leaves(tree)
    names = dict(model.named_parameters())
    if set(names) != set(leaves):
        raise ValueError("parameter names differ: port only "
                         f"{sorted(set(names) - set(leaves))}, JAX only "
                         f"{sorted(set(leaves) - set(names))}")
    for name, p in names.items():
        src = np.asarray(leaves[name])
        if src.dtype.name == "bfloat16":  # ml_dtypes: no torch.from_numpy
            src = src.astype(np.float32)
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {src.shape}, port {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.tensor(src, dtype=p.dtype))
    return model


def params_from_jax_sharded(cfg: ArchConfig, tree, mesh, device="cuda") -> Transformer:
    """:func:`params_from_jax`, then this rank's shards of it on ``mesh``
    (:func:`repro_torch.models.transformer.shard_model`)."""
    return shard_model(params_from_jax(cfg, tree, device=device), mesh)


def axes_to_jax_tree(axes: dict) -> dict:
    """The reference's logical-axes tree of the port's ``{name: axes}``
    (:func:`repro_torch.models.transformer.model_axes`): a block's leaves
    under ``blocks`` with the leading ``layers`` axis JAX stacks them on."""
    tree: dict = {}
    for name, ax in axes.items():
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            if i == "0":
                put_path(tree, ["blocks"] + rest.split("."), ("layers",) + tuple(ax))
            continue
        put_path(tree, name.split("."), tuple(ax))
    return tree


def params_to_jax_tree(named) -> dict:
    """The JAX package's nested dict of a ``{port name: tensor}`` mapping
    (``model.named_parameters()``, or a moment keyed as they are): the
    per-layer ``blocks.<i>.<path>`` leaves stacked on a leading L axis under
    ``blocks``, every other name split at its dots.  Tensors stay on their
    device (``meta`` makes a template of shapes and dtypes)."""
    tree: dict = {}
    stacks: dict = {}
    for name, leaf in dict(named).items():
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            stacks.setdefault(rest, {})[int(i)] = leaf
            continue
        put_path(tree, name.split("."), leaf)
    for rest, layers in stacks.items():
        put_path(tree, ["blocks"] + rest.split("."),
                 torch.stack([layers[i] for i in sorted(layers)]))
    return tree


def put_path(tree: dict, path: list, leaf) -> None:
    """Set ``leaf`` at ``path`` (a list of keys) in nested dicts."""
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf
