"""Gradient compression for cross-pod data parallelism.

Port of ``repro.distributed.compression``, with its arithmetic: int8
per-tensor quantization with **error feedback** (the residual carries to
the next step, so compression error does not bias convergence), applied to
the pod-axis gradient sync of the train step.

The trees are flat ``{name: tensor}`` mappings.  A tensor's scale is the
max over the *whole* tensor of the reference's tree: in the train step's
sync (:func:`pod_sync_compressed`, :func:`tensor_scales`) the layer leaves
``blocks.<i>.<path>`` of the port are one tensor, stacked over the layers
in the reference, and share its scale; on a mesh the leaves are this
rank's shards, and each leaf's local max is all-reduced over the axes its
spec cuts (one packed exchange an axis for the leaves cut alike) before
the quantization, as GSPMD's max does inside the reference's pod.  The
sum over ``pod`` is of the dequantized f32, divided by the pod count,
packed into exchanges of up to ``PACK_BYTES``.  Residuals stay per rank,
per pod, as the reference's ``shard_map`` keeps them.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import collectives as C

#: the bytes of dequantized gradients one exchange over the pod axis packs
PACK_BYTES = 1 << 28


def _scale_of(mx: torch.Tensor) -> torch.Tensor:
    return torch.clamp(mx, min=1e-12) / 127.0


def quantize_at(g32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8 levels of ``g32`` at ``scale``."""
    return torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)


def quantize_int8(g):
    """Per-tensor symmetric int8; returns (q, scale)."""
    g32 = g.to(torch.float32)
    scale = _scale_of(g32.abs().max())
    return quantize_at(g32, scale), scale


def stacked_name(name: str) -> str:
    """The reference's tensor that a port leaf is part of: a block's leaf
    ``blocks.<i>.<path>`` is layer i of ``blocks.<path>``."""
    parts = name.split(".")
    return ".".join(parts[:1] + parts[2:]) if parts[0] == "blocks" else name


def tensor_scales(g32: dict, cut_axes: dict | None = None) -> dict:
    """Each leaf's quantization scale: the max of |g| over the reference's
    whole tensor (:func:`stacked_name`), all-reduced over the mesh axes
    ``cut_axes`` names for the leaf (a tensor's layers are cut alike)."""
    mx: dict = {}
    for n, g in g32.items():
        key, m = stacked_name(n), g.abs().max()
        mx[key] = torch.maximum(mx[key], m) if key in mx else m
    groups: dict = {}
    for n in g32:
        axes = tuple(cut_axes[n]) if cut_axes else ()
        keys = groups.setdefault(axes, [])
        if stacked_name(n) not in keys:
            keys.append(stacked_name(n))
    for axes, keys in groups.items():
        if axes:
            got = C.all_reduce(torch.stack([mx[k] for k in keys]), axes, "max")
            mx.update({k: got[i] for i, k in enumerate(keys)})
    return {n: _scale_of(mx[stacked_name(n)]) for n in g32}


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_with_feedback(grads: dict, residuals: dict):
    """Returns (quantized_tree, new_residuals): each leaf's ``(q, scale)``
    of gradient + residual, and the residual g − deq(q)."""
    qtree, rtree = {}, {}
    for name, g in grads.items():
        g32 = g.to(torch.float32) + residuals[name]
        q, s = quantize_int8(g32)
        qtree[name] = (q, s)
        rtree[name] = g32 - dequantize_int8(q, s)
    return qtree, rtree


def decompress(qtree: dict, like: dict) -> dict:
    return {name: dequantize_int8(*qs).to(like[name].dtype) for name, qs in qtree.items()}


def pod_sync_compressed(grads: dict, residuals: dict, axis: str = "pod",
                        cut_axes: dict | None = None):
    """Quantize each leaf per pod (gradient + residual) at its tensor's
    scale (:func:`tensor_scales`), sum the dequantized f32 over the ranks
    of ``axis`` and divide by their count; returns (synced grads in their
    dtype, new residuals).  ``cut_axes`` ({name: mesh axes}) names the
    axes within a pod each leaf is a shard over, whose ranks share one
    scale."""
    names = list(grads)
    g32 = {n: grads[n].to(torch.float32) + residuals[n] for n in names}
    scales = tensor_scales(g32, cut_axes)
    deq, new_r = {}, {}
    for n in names:
        deq[n] = dequantize_int8(quantize_at(g32[n], scales[n]), scales[n])
        new_r[n] = g32[n] - deq[n]
    npod = C.axis_size(axis)
    out = {}
    for chunk in _chunks(names, deq):
        tot = C.all_reduce_packed([deq[n] for n in chunk], axis, "sum")
        out.update({n: (t / npod).to(grads[n].dtype) for n, t in zip(chunk, tot)})
    return out, new_r


def _chunks(names: list, tensors: dict, limit: int = PACK_BYTES) -> list:
    """``names`` in runs of at most ``limit`` bytes (one tensor at least)."""
    runs, cur, size = [], [], 0
    for n in names:
        nbytes = tensors[n].numel() * tensors[n].element_size()
        if cur and size + nbytes > limit:
            runs.append(cur)
            cur, size = [], 0
        cur.append(n)
        size += nbytes
    return runs + ([cur] if cur else [])


def init_residuals(params: dict) -> dict:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
