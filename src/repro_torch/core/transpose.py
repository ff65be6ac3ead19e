"""Pencil transposes — the paper's "fold communications" (§3.2.4).

Port of ``repro.core.transpose``.  A fold exchanges P equal blocks among
the P ranks of one grid dimension: block j of every rank goes to rank j,
and the received blocks concatenate in rank-major order (``tiled``
all-to-all semantics).  Two network models, as in the reference (§5.5):

* ``mode="switched"`` — one all-to-all (Fig. 5.10, Eq. 5.5);
* ``mode="torus"`` — P−1 ring rounds, round r shipping the block for rank
  me+r (:func:`ring_exchange`), or both torus directions at once in
  ⌈(P−1)/2⌉ rounds (:func:`ring_exchange_bidi`, Fig. 5.9).

A **wire** carries the exchanges of one grid dimension; the rank context
(:func:`repro_torch.dist.RankContext.wire`) picks it by device.  For CPU
tensors it is :class:`GlooWire`, the plain version: gloo's
``all_to_all_single`` for switched, ``batch_isend_irecv`` rounds for the
rings, and plain indexing to take and place blocks.  For CUDA tensors it
is the peer-mapped wire of the ring kernels
(:class:`repro_torch.kernels.ring_rdma.IpcWire`).  Both run the same round
schedule and give the same bits.  On a grid dimension of one rank there is
no wire (``None``) and every exchange is the identity.

A grid dimension over several communicating mesh axes (``u`` over
``("pod", "data")`` of a 3-axis mesh) has one wire per axis: the rings
take a tuple of them and run :func:`staged_exchange`, one single-axis
exchange per axis, innermost first, bit for bit the flat tiled
all-to-all; ``switched`` stays one all-to-all over the dimension's own
wire.  Every exchange meters the reference's wire counters
(:func:`_meter_exchange`), labelled by its wire.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as tdist

from repro_torch import obs

MODES = ("switched", "torus")


def _meter_exchange(wire, rounds: int, arrs, *, dispatch_kind: str,
                    dispatches: int) -> None:
    """Wire accounting of one single-axis block exchange over ``wire``, with
    the reference's counters (``repro.core.transpose._meter_exchange``):
    ``comm.exchanges.<label>``, ``comm.exchange_rounds.<label>`` (the wire
    rounds this exchange costs), ``comm.<kind>_dispatches`` and
    ``comm.wire_bytes`` (the bytes this rank ships: (p−1)/p of the
    arrays).  It runs with every exchange, in the rank that runs it; one
    branch when obs is disabled."""
    if not obs.is_enabled():
        return
    ax = wire.label
    obs.metrics.inc(f"comm.exchanges.{ax}")
    obs.metrics.inc(f"comm.exchange_rounds.{ax}", rounds)
    obs.metrics.inc(f"comm.{dispatch_kind}_dispatches", dispatches)
    payload = sum(a.numel() * a.element_size() for a in arrs)
    obs.metrics.inc("comm.wire_bytes", payload * (wire.p - 1) // wire.p)


def single_wire(wires):
    """``wires`` as one wire where it is one: a wire, or the only wire of a
    tuple (None for an empty one); a tuple of several stays a tuple (the
    stages of :func:`staged_exchange`)."""
    if isinstance(wires, (tuple, list)):
        return tuple(wires) if len(wires) > 1 else (wires[0] if wires else None)
    return wires


def ring_rounds(p: int) -> int:
    """Exchange rounds of the unidirectional ring: P−1 (Fig. 5.9, one NIC)."""
    return max(p - 1, 0)


def bidi_rounds(p: int) -> int:
    """Exchange rounds of the bidirectional ring: ``ceil((P−1)/2)``; when P
    is even the farthest block (P/2 hops either way) goes clockwise only."""
    return max(p, 1) // 2


def ring_schedule(p: int) -> list[list[int]]:
    """Round r ships the block for rank me+r: offsets ``[[1], …, [P−1]]``."""
    return [[r] for r in range(1, p)]


def bidi_schedule(p: int) -> list[list[int]]:
    """Round r ships block me+r clockwise and block me−r counter-clockwise,
    except the shared farthest block of an even ring (r == P−r)."""
    return [[r] if r == p - r else [r, -r] for r in range(1, bidi_rounds(p) + 1)]


def switched_schedule(p: int) -> list[list[int]]:
    """All P−1 foreign blocks posted in one round."""
    return [list(range(1, p))] if p > 1 else []


def stack_blocks(x: torch.Tensor, p: int, split_axis: int) -> torch.Tensor:
    """Cut ``x`` into P blocks along ``split_axis``, stacked on a fresh
    leading axis: (P, ..., blk, ...), a view."""
    split_axis %= x.dim()
    n = x.shape[split_axis]
    if n % p:
        raise ValueError(f"axis {split_axis} of length {n} does not split "
                         f"into {p} blocks")
    xs = x.reshape(x.shape[:split_axis] + (p, n // p) + x.shape[split_axis + 1:])
    return xs.movedim(split_axis, 0)


def merge_blocks(o: torch.Tensor, p: int, concat_axis: int) -> torch.Tensor:
    """Fold the leading rank axis of ``o`` into ``concat_axis`` in
    rank-major block order (tiled all-to-all semantics)."""
    concat_axis %= o.dim() - 1
    o = o.movedim(0, concat_axis)
    return o.reshape(o.shape[:concat_axis] + (p * o.shape[concat_axis + 1],)
                     + o.shape[concat_axis + 2:])


def block(x: torch.Tensor, j: int, p: int, axis: int) -> torch.Tensor:
    """Block ``j`` of ``p`` along ``axis`` of ``x`` (a view)."""
    size = x.shape[axis] // p
    return x.narrow(axis, j * size, size)


def merged_shape(shape, p: int, split_axis: int, concat_axis: int):
    """Shape of a tiled all-to-all's output for an input of ``shape``."""
    out = list(shape)
    out[split_axis] //= p
    out[concat_axis] *= p
    return tuple(out)


def run_schedule(schedule, post, land, between=None) -> None:
    """The round loop every wire runs: post round 0; then for each round r,
    post round r+1, run ``between(r)``, and land round r.  ``post(offsets)``
    returns what ``land(offsets, posted)`` needs to complete the round."""
    pending = {0: post(schedule[0])} if schedule else {}
    for r in range(len(schedule)):
        if r + 1 < len(schedule):
            pending[r + 1] = post(schedule[r + 1])
        if between is not None:
            between(r)
        land(schedule[r], pending.pop(r))


class GlooWire:
    """The plain wire of one grid dimension or mesh axis: gloo on CPU
    tensors.

    ``ranks`` are its global ranks in order and ``me`` this rank's index
    among them; ``label`` names it in the wire counters (the mesh axis, or
    a dimension's axes joined by ``*``).  ``fuses`` says whether the
    exchanges of :mod:`repro_torch.kernels.ring_rdma` may carry a payload
    on this wire (computed by its plain version); off unless a test turns
    it on.  ``exchanges`` and ``rounds`` count what the wire carried.
    """

    fuses = False

    def __init__(self, group, ranks: list[int], me: int, label: str):
        self.group, self.ranks, self.me = group, list(ranks), me
        self.label = label
        self.p = len(ranks)
        self.exchanges = 0
        self.rounds = 0

    def _count(self, rounds: int) -> None:
        self.exchanges += 1
        self.rounds += rounds

    def all_to_all(self, arrs, *, split_axis: int, concat_axis: int):
        """One ``all_to_all_single`` per array (one round)."""
        self._count(1)
        outs = []
        for x in arrs:
            xs = stack_blocks(x, self.p, split_axis).contiguous()
            o = torch.empty_like(xs)
            tdist.all_to_all_single(o, xs, group=self.group)
            outs.append(merge_blocks(o, self.p, concat_axis))
        return outs

    def exchange(self, arrs, schedule, *, split_axis: int, concat_axis: int,
                 between=None):
        """Run ``schedule`` (per round, the offsets r: ship block me+r to
        rank me+r, land block me−r from it); ``between(r)`` runs after
        round r+1 is posted and before round r is waited on."""
        self._count(len(schedule))
        p, me = self.p, self.me
        d = arrs[0].dim()
        split_axis, concat_axis = split_axis % d, concat_axis % d
        outs = [torch.empty(merged_shape(x.shape, p, split_axis, concat_axis),
                            dtype=x.dtype) for x in arrs]
        for x, o in zip(arrs, outs):
            block(o, me, p, concat_axis).copy_(block(x, me, p, split_axis))

        def post(offsets):
            ops, landing = [], []
            for off in offsets:
                dst, src = (me + off) % p, (me - off) % p
                for a, x in enumerate(arrs):
                    # tag: the sender's offset and the array, unique per round
                    tag = 2 * (off % p) + a
                    ops.append(tdist.P2POp(
                        tdist.isend, block(x, dst, p, split_axis).contiguous(),
                        self.ranks[dst], self.group, tag))
                    buf = torch.empty(block(x, dst, p, split_axis).shape,
                                      dtype=x.dtype)
                    ops.append(tdist.P2POp(tdist.irecv, buf, self.ranks[src],
                                           self.group, tag))
                    landing.append((a, src, buf))
            return tdist.batch_isend_irecv(ops), landing

        def land(offsets, posted):
            works, landing = posted
            for w in works:
                w.wait()
            for a, src, buf in landing:
                block(outs[a], src, p, concat_axis).copy_(buf)

        run_schedule(schedule, post, land, between)
        return outs

    def close(self) -> None:
        """Nothing to release."""


def exchange(arrs, wire, schedule, *, split_axis: int, concat_axis: int,
             interleave=None):
    """Tiled all-to-all of same-shaped ``arrs`` over ``wire`` by
    ``schedule``; ``interleave()`` runs once the first rounds are posted
    (the Fig. 4.3 overlap window).  Returns ``(outs, interleave result)``."""
    follow = []

    def between(r):
        if r == 0 and interleave is not None:
            follow.append(interleave())
    outs = wire.exchange(arrs, schedule, split_axis=split_axis,
                         concat_axis=concat_axis, between=between)
    return outs, (follow[0] if follow else None)


def staged_exchange(arrs, wires, *, split_axis: int, concat_axis: int,
                    exchange, interleave=None, **first_stage_kw):
    """One tiled all-to-all over several mesh axes as sequential per-axis
    exchanges (``repro.core.transpose.staged_exchange``): ``wires`` holds
    one wire per mesh axis, outermost first.

    The blocks' leading rank axis is reshaped to the axes' sizes
    ``(q₀, q₁, …)``, row-major like the flat rank; then, innermost axis
    first, axis i of that block grid is moved to the front and exchanged
    over ``wires[i]`` (``exchange(cur, wire, split_axis=0,
    concat_axis=0, **kw)``, a single-axis primitive such as
    :func:`ring_exchange`).  The result is the flat tiled all-to-all's, bit
    for bit, in Σᵢ rounds(qᵢ) rounds.  ``interleave`` and any
    ``first_stage_kw`` (a payload) ride the first stage and no other: later
    stages relay blocks that are already transformed.
    """
    sizes = tuple(w.p for w in wires)
    p, k = math.prod(sizes), len(wires)
    xss = [stack_blocks(x, p, split_axis) for x in arrs]
    xss = [x.reshape(sizes + x.shape[1:]) for x in xss]
    follow, first = None, True
    for i in reversed(range(k)):
        cur = [x.movedim(i, 0) for x in xss]
        kw = dict(first_stage_kw) if first else {}
        if first and interleave is not None:
            kw["interleave"] = interleave
        outs, fl = exchange(cur, wires[i], split_axis=0, concat_axis=0, **kw)
        if first:
            follow, first = fl, False
        xss = [o.movedim(0, i) for o in outs]
    xss = [x.reshape((p,) + x.shape[k:]) for x in xss]
    return [merge_blocks(x, p, concat_axis) for x in xss], follow


def all_to_all_blocks(x: torch.Tensor, wire, *, split_axis: int,
                      concat_axis: int, mode: str = "switched") -> torch.Tensor:
    """Exchange the P equal blocks of ``x`` (split along ``split_axis``) so
    block j goes to rank j, concatenated along ``concat_axis`` by source
    rank.  ``switched`` takes the dimension's own wire (one all-to-all,
    one round); ``torus`` its wire or its per-axis wires (the staged
    ring).  With no wire (one rank) that is ``x`` itself."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    wire = single_wire(wire)
    if wire is None:
        return x
    if mode == "switched":
        _meter_exchange(wire, 1, (x,), dispatch_kind="all_to_all", dispatches=1)
        return wire.all_to_all([x], split_axis=split_axis,
                               concat_axis=concat_axis)[0]
    outs, _ = ring_exchange([x], wire, split_axis=split_axis,
                            concat_axis=concat_axis)
    return outs[0]


def ring_exchange(arrs, wire, *, split_axis: int, concat_axis: int,
                  interleave=None):
    """P−1 rounds over same-shaped ``arrs``; round r ships the block for
    rank (me+r) mod P and lands the one from (me−r) mod P.  A tuple of
    per-axis wires runs :func:`staged_exchange`, one ring per mesh axis.
    Returns ``(outs, interleave result)``."""
    wire = single_wire(wire)
    if isinstance(wire, tuple):
        return staged_exchange(arrs, wire, split_axis=split_axis,
                               concat_axis=concat_axis, exchange=ring_exchange,
                               interleave=interleave)
    _meter_exchange(wire, ring_rounds(wire.p), arrs, dispatch_kind="ppermute",
                    dispatches=ring_rounds(wire.p) * len(arrs))
    return exchange(arrs, wire, ring_schedule(wire.p), split_axis=split_axis,
                    concat_axis=concat_axis, interleave=interleave)


def ring_exchange_bidi(arrs, wire, *, split_axis: int, concat_axis: int,
                       interleave=None):
    """The ring over both torus directions (Fig. 5.9), ⌈(P−1)/2⌉ rounds;
    the same blocks and merge as :func:`ring_exchange`, bit for bit, and
    the same staging over per-axis wires."""
    wire = single_wire(wire)
    if isinstance(wire, tuple):
        return staged_exchange(arrs, wire, split_axis=split_axis,
                               concat_axis=concat_axis,
                               exchange=ring_exchange_bidi, interleave=interleave)
    p = wire.p
    # the reference's ppermute count: a clockwise stream a round, and a
    # counter-clockwise one except the shared farthest block of an even ring
    ccw = bidi_rounds(p) - (1 if p % 2 == 0 else 0)
    _meter_exchange(wire, bidi_rounds(p), arrs, dispatch_kind="ppermute",
                    dispatches=(bidi_rounds(p) + ccw) * len(arrs))
    return exchange(arrs, wire, bidi_schedule(p), split_axis=split_axis,
                    concat_axis=concat_axis, interleave=interleave)


def permute_last3(a: torch.Tensor, perm: tuple[int, int, int]) -> torch.Tensor:
    """Apply a permutation of the LAST THREE axes; leading axes untouched.

    The ``CommStep.permute`` executor: ``(2, 1, 0)`` is the X↔Y fold's
    transpose, ``(0, 2, 1)`` the Y↔Z fold's.  Returns a view.
    """
    d = a.dim()
    return a.permute(*range(d - 3), *(d - 3 + i for i in perm))
