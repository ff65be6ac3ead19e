"""Shared model plumbing of the port: parameter init on an explicit
``torch.Generator``, and the norms.

Port of ``repro.models.common``.  The JAX package records each leaf's
logical axes in a mirror tree as it creates it; the port's modules declare
theirs (``AXES``, read by :func:`repro_torch.models.transformer.model_axes`).
``shard_act`` has no counterpart: the port places its collectives where
GSPMD would, so it constrains no activation.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

#: the dtypes the LM path runs in (the attention kernel takes these two)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: the decoder's stacks of blocks, in the order they run: the leading
#: dense blocks of a MoE model (deepseek-v2's ``first_dense``), then the
#: rest.  The reference stacks each on a leading layer axis; the port names
#: a block's leaves ``<stack>.<i>.<path>``
STACKS = ("first_blocks", "blocks")


def split_stacked(name: str):
    """``(stack, layer, path)`` of a block's leaf ``<stack>.<i>.<path>``, or
    None for a leaf outside the stacks."""
    parts = name.split(".", 2)
    if parts[0] in STACKS and len(parts) == 3:
        return parts[0], int(parts[1]), parts[2]
    return None


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, ...)."""
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(DTYPES)}")
    return DTYPES[name]


class Initializer:
    """Creates parameters with the JAX package's scales: normal times
    ``1/sqrt(shape[0])`` by default (``common.py:39``), zeros or ones.
    Values come from ``generator`` in creation order; they are not the JAX
    package's values for the same seed (tests carry those across with
    :func:`repro_torch.models.convert.params_from_jax`).  On the ``meta``
    device it makes shapes only."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device="cuda"):
        self.generator = generator
        self.dtype = dtype
        self.device = resolve_device(device)

    def param(self, shape, scale: float | None = None, mode: str = "normal"):
        shape = tuple(shape)
        if self.device.type == "meta":
            w = torch.empty(shape, dtype=self.dtype, device=self.device)
        elif mode == "zeros":
            w = torch.zeros(shape, dtype=self.dtype, device=self.device)
        elif mode == "ones":
            w = torch.ones(shape, dtype=self.dtype, device=self.device)
        else:
            if scale is None:
                scale = 1.0 / max(shape[0], 1) ** 0.5
            w = (scale * torch.randn(shape, dtype=torch.float32, device=self.device,
                                     generator=self.generator)).to(self.dtype)
        return torch.nn.Parameter(w, requires_grad=False)

    def stacked(self, n: int) -> "Stacked":
        """An initializer of ``n`` sub-layers' parameters stacked on a
        leading ``sub`` axis (the reference's ``_stack_inits`` inside a
        Jamba superblock)."""
        return Stacked(self, n)


class Stacked:
    """:meth:`Initializer.stacked`: ``param(shape)`` makes an (n, *shape)
    parameter, each sub-layer drawn at its own shape's scale.  Its normal
    values are drawn a slab of rows at a time, so that the f32 draw of a
    large stack (a Jamba MoE layer's experts) is never held whole."""

    #: the most f32 values drawn at once
    SLAB = 1 << 26

    def __init__(self, ini: Initializer, n: int):
        self.ini = ini
        self.n = n

    def param(self, shape, scale: float | None = None, mode: str = "normal"):
        ini, shape = self.ini, tuple(shape)
        full = (self.n,) + shape
        if ini.device.type == "meta" or mode != "normal":
            return ini.param(full, mode=mode)
        if scale is None:
            scale = 1.0 / max(shape[0], 1) ** 0.5
        w = torch.empty(full, dtype=ini.dtype, device=ini.device)
        flat = w.view(-1, shape[-1]) if shape else w.view(-1, 1)
        step = max(1, self.SLAB // flat.shape[1])
        for r in range(0, flat.shape[0], step):
            rows = flat[r:r + step]
            rows.copy_(scale * torch.randn(rows.shape, dtype=torch.float32,
                                           device=ini.device, generator=ini.generator))
        return torch.nn.Parameter(w, requires_grad=False)


def rms_norm(x, w, eps: float = 1e-6, plus_one: bool = False):
    """RMSNorm in f32, cast back to x's dtype (``common.py:63``)."""
    dt = x.dtype
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (x32 * inv * scale).to(dt)


def layer_norm(x, w, b, eps: float = 1e-5):
    """LayerNorm in f32, cast back to x's dtype (``common.py:71``)."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)
