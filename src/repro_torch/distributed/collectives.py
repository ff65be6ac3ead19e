"""The collectives GSPMD inserts in the reference, over the ranks of the
current :class:`repro_torch.dist.RankContext`.

``all_gather``, ``reduce_scatter`` and ``all_reduce`` (``op="sum"`` or
``"max"``) act over one mesh axis, or several (applied one axis after the
other: a gather innermost axis first, so that blocks land row-major over
the axes as :func:`repro_torch.distributed.sharding.shard_of` cuts them).
Each moves its tensor as one all-to-all over the axis' wire
(:meth:`repro_torch.dist.RankContext.wire`): on CUDA tensors the
peer-mapped :class:`repro_torch.kernels.ring_rdma.IpcWire`, whose blocks
travel on ``ring_send`` and land on ``ring_land``; on CPU tensors the
axis' gloo wire.  No NCCL, and no gloo for a CUDA tensor.

* a gather sends every peer the same block (an expanded view: no copy);
* a reduction exchanges blocks and sums (or maxes) the received ones in
  rank order, so every rank of the axis gets the same bits.  An
  all-reduce is a gather and that ordered reduction.

The wire carries 4- and 8-byte words (its copies move 16-, 8- or 4-byte
units).  A tensor of another type (bf16 activations, int64 tokens) travels
as the 4-byte words of its bytes, zero-padded to a whole word, and is
viewed back on arrival: no cast.  :func:`exchange_packed` sends several
tensors as one flat buffer, so that a block's parameters cost one
exchange, not one each.

Under autograd (``torch.autograd.Function``\\ s):

* :func:`gather_packed`, FSDP's parameter gather, has a reduce-scatter as
  its backward;
* :func:`reduce_from` — the row-parallel all-reduce — has the identity
  as its backward;
* :func:`copy_to` — the column-parallel input's identity — has an
  all-reduce as its backward (:func:`copy_to_packed` for several
  tensors in one exchange).

``calls`` counts the collectives by kind and ``wire_bytes`` the bytes this
rank sent; nothing else adds to them.
"""

from __future__ import annotations

import torch

from repro_torch import dist
from repro_torch.distributed import sharding as SH

calls = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
wire_bytes = 0

_WORD = torch.float32


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _context():
    ctx = dist.context()
    if ctx is None:
        raise RuntimeError("a collective over mesh axes runs inside the ranks "
                           "of repro_torch.dist.run_ranks")
    return ctx


def axis_size(axis: str) -> int:
    """The size of mesh ``axis`` of the running ranks' mesh (1 when the
    mesh has no such axis or there are no ranks)."""
    ctx = dist.context()
    if ctx is None:
        return 1
    grid = ctx.grid()
    for dim in ("u", "v"):
        sizes = dict(zip(grid.dim_axes(dim), grid.dim_sizes(dim)))
        if axis in sizes:
            return sizes[axis]
    return 1


def _wire(axis: str, device):
    """The wire of mesh ``axis`` for tensors on ``device``, or None for an
    axis of one rank."""
    ctx = _context()
    grid = ctx.grid()
    for dim in ("u", "v"):
        sizes = dict(zip(grid.dim_axes(dim), grid.dim_sizes(dim)))
        if axis not in sizes:
            continue
        if sizes[axis] == 1:
            return None
        if len(grid.comm_axes(dim)) == 1:  # the dimension's own wire is the axis'
            return ctx.wire(dim, device)
        return ctx.wire(dim, device, axis=axis)
    raise ValueError(f"mesh axis {axis!r} is not an axis of the "
                     f"{grid.mesh_label} mesh ({grid.u_axes + grid.v_axes})")


def _words(flat: torch.Tensor) -> torch.Tensor:
    """A 1-D contiguous tensor as 4-byte words (a view where it is f32;
    otherwise its bytes, zero-padded to a whole word)."""
    if flat.dtype == _WORD:
        return flat
    raw = flat.view(torch.uint8)
    pad = -raw.numel() % 4
    if pad:
        raw = torch.cat([raw, raw.new_zeros(pad)])
    return raw.view(_WORD)


def _unwords(words: torch.Tensor, dtype: torch.dtype, numel: int) -> torch.Tensor:
    """The last axis of ``words`` read back as ``numel`` elements of ``dtype``."""
    if dtype == _WORD:
        return words[..., :numel]
    raw = words.contiguous().view(torch.uint8)
    size = torch.empty((), dtype=dtype).element_size()
    return raw[..., :numel * size].view(dtype)


def _exchange(rows: torch.Tensor, axis: str) -> torch.Tensor:
    """``rows`` (P, n) words, row j for the axis' rank j (a stride-0 view
    when every rank gets the same row) → (P, n) words, row j from rank j."""
    global wire_bytes
    wire = _wire(axis, rows.device)
    if wire is None:
        return rows
    wire_bytes += (wire.p - 1) * rows.shape[1] * rows.element_size()
    return wire.all_to_all([rows], split_axis=0, concat_axis=0)[0]


def exchange_packed(parts: list, axis: str, *, same: bool) -> list:
    """Send tensors to the ranks of ``axis`` as one flat buffer of words.

    With ``same``, ``parts`` is a list of tensors every rank of the axis
    gets; returns, for each rank j of the axis in order, the list of its
    tensors (shapes and dtypes as ours).  Else ``parts`` is a list (one a
    rank of the axis, in order) of lists of tensors for that rank, all
    with one list of shapes and dtypes; returns the lists received, by
    source rank."""
    p = axis_size(axis)
    mine = parts if same else parts[0]
    metas = [(t.shape, t.dtype, t.numel()) for t in mine]
    offs = [0]
    for t in mine:
        offs.append(offs[-1] + -(-t.numel() * t.element_size() // 4))

    def pack(ts):
        return torch.cat([_words(t.contiguous().reshape(-1)) for t in ts])

    if same:
        buf = pack(parts)
        rows = buf.unsqueeze(0).expand(p, buf.numel())
    else:
        rows = torch.stack([pack(ts) for ts in parts])
    got = _exchange(rows, axis)
    return [[_unwords(got[j, offs[i]:offs[i + 1]], dt, n).reshape(sh)
             for i, (sh, dt, n) in enumerate(metas)] for j in range(p)]


def _ordered(xs: list, op: str) -> torch.Tensor:
    """Sum or max of ``xs`` in their order (rank order)."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x if op == "sum" else torch.maximum(out, x)
    return out


# ---------------------------------------------------------------------------
# the collectives (no autograd)
# ---------------------------------------------------------------------------


def all_gather(x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
    """The blocks of ``x`` of the ranks of ``axes``, concatenated along
    ``dim`` in rank order (row-major over several axes)."""
    return _gather_packed([x], [dim], _axes(axes))[0]


def reduce_scatter(x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
    """The sum over the ranks of ``axes`` of ``x``, cut along ``dim`` into
    one block a rank (row-major over several axes); this rank's block."""
    return _scatter_packed([x], [dim], _axes(axes))[0]


def all_reduce(x: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
    """The sum (``op="sum"``) or max (``"max"``) of ``x`` over the ranks of
    ``axes``; the same bits on every one of them."""
    return all_reduce_packed([x], axes, op)[0]


def all_reduce_packed(xs: list, axes, op: str = "sum") -> list:
    """:func:`all_reduce` of several tensors in one exchange an axis."""
    if op not in ("sum", "max"):
        raise ValueError(f"op must be 'sum' or 'max', got {op!r}")
    calls["all_reduce"] += 1
    for axis in _axes(axes):
        if axis_size(axis) > 1:
            got = exchange_packed(list(xs), axis, same=True)
            xs = [_ordered([g[i] for g in got], op) for i in range(len(xs))]
    return list(xs)


# ---------------------------------------------------------------------------
# under autograd
# ---------------------------------------------------------------------------


def gather_packed(xs: list, dims: list, axes) -> list:
    """FSDP's gather of several tensors in one exchange an axis: each
    ``xs[i]`` gathered along ``dims[i]`` over ``axes``.  Under autograd
    its backward reduce-scatters each gradient back to this rank's block,
    again one exchange an axis."""
    axes = _axes(axes)
    if not xs or not _live(axes):
        return list(xs)
    return list(_GatherPacked.apply(tuple(dims), axes, *xs))


def _gather_packed(xs, dims, axes):
    calls["all_gather"] += 1
    xs = list(xs)
    for axis in reversed(axes):
        if axis_size(axis) > 1:
            got = exchange_packed(xs, axis, same=True)
            xs = [torch.cat([g[i] for g in got], dim=d) for i, d in enumerate(dims)]
    return xs


def _scatter_packed(gs, dims, axes):
    calls["reduce_scatter"] += 1
    gs = list(gs)
    for axis in axes:
        p = axis_size(axis)
        if p > 1:
            blocks = [[torch.chunk(g, p, dim=d)[j] for g, d in zip(gs, dims)]
                      for j in range(p)]
            got = exchange_packed(blocks, axis, same=False)
            gs = [_ordered([g[i] for g in got], "sum") for i in range(len(gs))]
    return gs


class _GatherPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dims, axes, *xs):
        ctx.dims, ctx.axes = dims, axes
        outs = tuple(_gather_packed(xs, dims, axes))
        ctx.full = [(o.shape, o.dtype, o.device) for o in outs]
        return outs

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(sh, dtype=dt, device=dev) if g is None else g
              for g, (sh, dt, dev) in zip(gs, ctx.full)]
        return (None, None, *_scatter_packed(gs, ctx.dims, ctx.axes))


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, op):
        return all_reduce(x, axes, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axes, *xs):
        ctx.axes = axes
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *all_reduce_packed([g.contiguous() for g in gs], ctx.axes, "sum"))


def reduce_from(x, axes, op: str = "sum"):
    """The row-parallel all-reduce: :func:`all_reduce` forward, the
    identity backward (every rank holds the reduced value and seeds its
    own gradient)."""
    axes = _axes(axes)
    return _ReduceFrom.apply(x, axes, op) if _live(axes) else x


def copy_to(x, axes):
    """The column-parallel input: the identity forward, an all-reduce of
    the gradient backward (each rank's consumer saw only its block)."""
    return copy_to_packed([x], axes)[0]


def copy_to_packed(xs: list, axes) -> list:
    """:func:`copy_to` of several tensors, their gradients all-reduced in
    one exchange an axis (parameters whole on a batch axis, whose
    gradient each rank computed from its rows only)."""
    axes = _axes(axes)
    if not xs or not _live(axes):
        return list(xs)
    return list(_CopyTo.apply(axes, *xs))


def _live(axes) -> bool:
    return any(axis_size(a) > 1 for a in axes)


def gather_full(named: dict, specs: dict) -> dict:
    """The whole tensors of shards ``named`` ({name: shard}) cut by
    ``specs`` ({name: spec}), on every rank: each cut dim gathered over its
    entry's axes, the leaves cut over the same axes in one packed exchange
    an axis (no autograd)."""
    out = dict(named)
    pending = {n: [(d, SH.entry_axes(e)) for d, e in enumerate(specs[n])
                   if SH.entry_axes(e)] for n in named}
    while any(pending.values()):
        groups: dict = {}
        for n, cuts in pending.items():
            if cuts:
                dim, axes = cuts.pop(0)
                groups.setdefault(axes, []).append((n, dim))
        for axes, leaves in groups.items():
            got = _gather_packed([out[n] for n, _ in leaves], [d for _, d in leaves],
                                 axes)
            out.update({n: g for (n, _), g in zip(leaves, got)})
    return out
