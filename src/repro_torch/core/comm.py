"""TransposeEngine — the fold-communication layer (paper §4.2–4.3).

Port of ``repro.core.comm``.  The five registered engines keep the
reference's names, so a reference plan config selects the same one:

* ``switched`` — one all-to-all per fold (Fig. 5.10, Eq. 5.5);
* ``torus`` — P−1 ring rounds per fold (Fig. 5.9, Eq. 5.6);
* ``overlap_ring`` — the ring with the 1D FFT of the next slab emitted
  between its rounds (Fig. 4.3);
* ``pallas_ring`` — the same schedule through the NIC engine of
  :mod:`repro_torch.kernels.ring_rdma`; when the phase butterflies are the
  radix-2 kernel on a c2c step and the wire fuses a payload, they run as
  the exchange's payload between a round's send and its wait;
* ``bidi_ring`` — the NIC engine over both ring directions, ⌈(P−1)/2⌉
  rounds.

On a grid dimension of one rank a fold is a local permute and every engine
runs the base slab schedule below, as the reference's ``p <= 1`` branches
do.  Over more ranks the exchanges go over the wires of the step's grid
dimension (:meth:`repro_torch.dist.RankContext.wire`): gloo for CPU
tensors, the peer-mapped wire of the ring kernels for CUDA tensors.
``switched`` takes the dimension's own wire, one all-to-all over all its
ranks; the ring engines take one wire per communicating mesh axis
(:meth:`~repro_torch.dist.RankContext.axis_wires`), so a dimension over
several axes (``u`` over ``("pod", "data")``) runs the staged exchange,
one ring per axis.

The scheduling contract is the reference's: ``run_fold`` (butterflies then
fold), ``run_unfold`` (unfold then butterflies) and ``run_roundtrip`` (fold,
folded-pencil kernel, unfold, slab by slab), each over one
:class:`~repro_torch.core.decomposition.CommStep`.  The slab boundaries are
the reference's too, because they decide which rows a
``DiagonalKernel.apply(lo, hi)`` slices.  Ring engines count the wire
rounds their exchanges cost in ``exchange_rounds`` and in the counter
``comm.engine_exchange_rounds.<engine>``: Σᵢ ``wire_rounds(qᵢ)`` over the
communicating mesh axes per exchange.
"""

from __future__ import annotations

import torch

from repro_torch import dist, obs
from repro_torch.core import decomposition as dec
from repro_torch.core import transpose as tr
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.kernels import ring_rdma


def _slabs(size: int, chunks: int) -> tuple[int, int]:
    """``(count, stride)`` of the slab split: the largest count ≤ ``chunks``
    that divides ``size``."""
    c = min(max(chunks, 1), size)
    while size % c:
        c -= 1
    return c, size // c


def run_chunked(fn, arrs, axis: int, chunks: int):
    """Apply ``fn`` per slab along ``axis`` (same axis in/out), concat results."""
    if chunks == 1:
        return fn(*arrs)
    axis = axis % arrs[0].dim()
    c, step = _slabs(arrs[0].shape[axis], chunks)
    outs = [fn(*(a.narrow(axis, i * step, step) for a in arrs))
            for i in range(c)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[j] for o in outs], dim=axis)
                     for j in range(len(outs[0])))
    return torch.cat(outs, dim=axis)


def _cat(outs, axis: int):
    return tuple(torch.cat([o[k] for o in outs], dim=axis)
                 for k in range(len(outs[0])))


# ---------------------------------------------------------------------------
# engine registry
# ---------------------------------------------------------------------------

ENGINES: dict[str, type] = {}


def _register(cls):
    ENGINES[cls.name] = cls
    return cls


def build_engine(spec: EngineSpec, grid) -> "TransposeEngine":
    """Instantiate the engine an :class:`EngineSpec` names, for a grid."""
    try:
        cls = ENGINES[spec.engine]
    except KeyError:
        raise ValueError(f"unknown comm engine {spec.engine!r}; "
                         f"have {sorted(ENGINES)}") from None
    return cls(grid, spec)


def engine_fabric(name: str) -> str:
    """The §5.5 network fabric an engine needs sizing for."""
    try:
        return ENGINES[name].fabric
    except KeyError:
        raise ValueError(
            f"unknown comm engine {name!r}; have {sorted(ENGINES)}") from None


# ---------------------------------------------------------------------------
# base engine: phase = compute + fold, scheduled at slab granularity
# ---------------------------------------------------------------------------

class TransposeEngine:
    """Interface + slab-granular base schedule."""

    name = "base"
    mode = "switched"    # wire format of the block exchange
    fabric = "switched"  # §5.5 network the engine maps onto

    def __init__(self, grid, spec: EngineSpec):
        self.grid = grid
        self.spec = spec
        self.chunks = max(int(spec.chunks), 1)
        self.backend = spec.backend
        # wire rounds of the exchanges routed through the ring engines'
        # hooks (the base/switched/torus relayouts keep 0, as in the
        # reference)
        self.exchange_rounds = 0

    def _wire(self, step: dec.CommStep, device):
        """The wires of the step's grid dimension for tensors on ``device``:
        for ``switched`` the dimension's own wire, for the rings a tuple of
        one wire per communicating mesh axis, outermost first (None on a
        dimension of one rank)."""
        if self.grid.dim_ranks(step.grid_dim) <= 1:
            return None
        ctx = dist.context()
        if ctx is None:
            raise RuntimeError(f"a fold over a {self.grid.mesh_label} mesh "
                               "runs inside repro_torch.dist.run_ranks")
        if self.mode == "switched":
            return ctx.wire(step.grid_dim, device)
        return ctx.axis_wires(step.grid_dim, device)

    # ---- relayout primitives (pure data movement) ------------------------
    def fold_step(self, step: dec.CommStep, a: torch.Tensor) -> torch.Tensor:
        """One CommStep's fold: block exchange over the step's grid
        dimension, then the step's local permute (materialised)."""
        d = a.dim()
        b = tr.all_to_all_blocks(a, self._wire(step, a.device),
                                 split_axis=d + step.split_offset,
                                 concat_axis=d + step.concat_offset,
                                 mode=self.mode)
        return tr.permute_last3(b, step.permute).contiguous()

    def unfold_step(self, step: dec.CommStep, a: torch.Tensor) -> torch.Tensor:
        """Inverse relayout: the step's permute, then the inverse exchange."""
        d = a.dim()
        b = tr.permute_last3(a, step.permute).contiguous()
        return tr.all_to_all_blocks(b, self._wire(step, a.device),
                                    split_axis=d + step.unfold_split,
                                    concat_axis=d + step.unfold_concat,
                                    mode=self.mode)

    # ---- scheduling contract ---------------------------------------------
    def run_fold(self, step: dec.CommStep, compute, arrs):
        """Forward phase: butterflies (``compute``) then the step's fold,
        slab by slab along the step's ``slab_offset`` axis."""
        def phase(*sl):
            return tuple(self.fold_step(step, o) for o in compute(*sl))
        return run_chunked(phase, arrs, axis=step.slab_offset,
                           chunks=self.chunks)

    def run_unfold(self, step: dec.CommStep, compute, arrs):
        """Inverse phase: the step's unfold relayout then butterflies."""
        def phase(*sl):
            return compute(*(self.unfold_step(step, a) for a in sl))
        return run_chunked(phase, arrs, axis=step.slab_offset,
                           chunks=self.chunks)

    def run_roundtrip(self, step: dec.CommStep, fwd, kernel, inv, arrs, *,
                      diag=None):
        """Spectral roundtrip over one CommStep, slab by slab: ``fwd`` →
        fold → ``kernel(zr, zi, lo, hi)`` on the folded slab with its row
        range ``[lo, hi)`` → unfold → ``inv``.  ``diag`` (the raw planar
        multiplier) is for engines that fuse the multiply into their
        exchange; the base schedule ignores it."""
        del diag
        axis = step.slab_offset % arrs[0].dim()
        c, stride = _slabs(arrs[0].shape[axis], self.chunks)
        outs = []
        for i in range(c):
            sl = [a.narrow(axis, i * stride, stride) for a in arrs]
            cr, ci = fwd(*sl)
            zr = self.fold_step(step, cr)
            zi = self.fold_step(step, ci)
            kr, ki = kernel(zr, zi, i * stride, (i + 1) * stride)
            ur = self.unfold_step(step, kr)
            ui = self.unfold_step(step, ki)
            outs.append(inv(ur, ui))
        return _cat(outs, axis)


@_register
class SwitchedEngine(TransposeEngine):
    """One all-to-all per fold (Fig. 5.10 / Eq. 5.5)."""

    name = "switched"
    mode = "switched"
    fabric = "switched"


@_register
class TorusEngine(TransposeEngine):
    """P−1 ring rounds per fold (Fig. 5.9 / Eq. 5.6)."""

    name = "torus"
    mode = "torus"
    fabric = "torus"


# ---------------------------------------------------------------------------
# overlap ring: the ring with butterflies emitted between its rounds
# ---------------------------------------------------------------------------

@_register
class OverlapRingEngine(TorusEngine):
    """The ring with the 1D FFT fused into it (Fig. 4.3, tasks C/G).

    Forward: slab i+1's butterflies run between slab i's ring rounds.
    Inverse: slab i−1's butterflies (on blocks already received) run
    between slab i's rounds.  Every exchange goes through
    ``self._exchange``, the one hook a subclass overrides to swap the
    transport.
    """

    name = "overlap_ring"

    #: wire rounds one exchange costs over a P-rank grid dimension
    wire_rounds = staticmethod(tr.ring_rounds)

    def _count_rounds(self, step: dec.CommStep) -> None:
        """Σ ``wire_rounds(qᵢ)`` over the communicating mesh axes of the
        step's grid dimension: the staged exchange's rounds."""
        rounds = sum(self.wire_rounds(q) for _, q in self.grid.comm_axes(step.grid_dim))
        self.exchange_rounds += rounds
        if obs.is_enabled():  # the counter's name is formatted only then
            obs.metrics.inc(f"comm.engine_exchange_rounds.{self.name}", rounds)

    # ---- the transport hook ----------------------------------------------
    def _exchange(self, arrs, step, *, split_axis: int, concat_axis: int,
                  interleave=None):
        """Tiled ring all-to-all of same-shaped ``arrs`` (+ fused thunk)."""
        self._count_rounds(step)
        return tr.ring_exchange(arrs, self._wire(step, arrs[0].device),
                                split_axis=split_axis, concat_axis=concat_axis,
                                interleave=interleave)

    # ---- relayout primitives routed through the transport hook -----------
    def fold_step(self, step: dec.CommStep, a):
        if self.grid.dim_ranks(step.grid_dim) <= 1:
            return super().fold_step(step, a)
        d = a.dim()
        outs, _ = self._exchange((a,), step, split_axis=d + step.split_offset,
                                 concat_axis=d + step.concat_offset)
        return tr.permute_last3(outs[0], step.permute).contiguous()

    def unfold_step(self, step: dec.CommStep, a):
        if self.grid.dim_ranks(step.grid_dim) <= 1:
            return super().unfold_step(step, a)
        b = tr.permute_last3(a, step.permute).contiguous()
        d = b.dim()
        outs, _ = self._exchange((b,), step, split_axis=d + step.unfold_split,
                                 concat_axis=d + step.unfold_concat)
        return outs[0]

    # ---- overlapped phase schedules --------------------------------------
    def _n_slabs(self, size: int, ranks: int) -> int:
        ns = self.chunks if self.chunks > 1 else max(ranks, 2)
        ns = min(ns, size)
        while size % ns:
            ns -= 1
        return max(ns, 1)

    def _slabbing(self, step: dec.CommStep, arrs):
        """(axis, slab count, stride, slab(i)) of an overlapped phase."""
        axis = step.slab_offset % arrs[0].dim()
        size = arrs[0].shape[axis]
        ns = self._n_slabs(size, self.grid.dim_ranks(step.grid_dim))
        stride = size // ns

        def slab(i):
            return tuple(a.narrow(axis, i * stride, stride) for a in arrs)
        return axis, ns, stride, slab

    def _fold_exchange(self, step, cur, **kw):
        d = cur[0].dim()
        return self._exchange((cur[0], cur[1]), step,
                              split_axis=d + step.split_offset,
                              concat_axis=d + step.concat_offset, **kw)

    def _unfold_exchange(self, step, mid, **kw):
        br = tr.permute_last3(mid[0], step.permute)
        bi = tr.permute_last3(mid[1], step.permute)
        d = br.dim()
        return self._exchange((br, bi), step, split_axis=d + step.unfold_split,
                              concat_axis=d + step.unfold_concat, **kw)

    @staticmethod
    def _permuted(step, pair):
        return (tr.permute_last3(pair[0], step.permute),
                tr.permute_last3(pair[1], step.permute))

    def run_fold(self, step: dec.CommStep, compute, arrs):
        if self.grid.dim_ranks(step.grid_dim) <= 1:
            return super().run_fold(step, compute, arrs)
        axis, ns, _, slab = self._slabbing(step, arrs)
        cur = compute(*slab(0))
        outs = []
        for i in range(ns):
            nxt = (lambda j=i + 1: compute(*slab(j))) if i + 1 < ns else None
            ex, follow = self._fold_exchange(step, cur, interleave=nxt)
            outs.append(self._permuted(step, ex))
            cur = follow
        return _cat(outs, axis)

    def run_unfold(self, step: dec.CommStep, compute, arrs):
        if self.grid.dim_ranks(step.grid_dim) <= 1:
            return super().run_unfold(step, compute, arrs)
        axis, ns, _, slab = self._slabbing(step, arrs)
        outs = []
        prev = None
        for i in range(ns):
            thunk = (lambda c=prev: compute(*c)) if prev is not None else None
            ex, done = self._unfold_exchange(step, slab(i), interleave=thunk)
            if done is not None:
                outs.append(done)
            prev = (ex[0], ex[1])
        outs.append(compute(*prev))
        return _cat(outs, axis)

    def run_roundtrip(self, step: dec.CommStep, fwd, kernel, inv, arrs, *,
                      diag=None):
        """The slab-streamed roundtrip: slab k's kernel and slab k−2's
        inverse butterflies run in slab k−1's unfold-exchange overlap
        window, while slab k+1's forward butterflies ride slab k's fold
        exchange."""
        if self.grid.dim_ranks(step.grid_dim) <= 1:
            return super().run_roundtrip(step, fwd, kernel, inv, arrs, diag=diag)
        axis, ns, stride, slab = self._slabbing(step, arrs)
        cur = fwd(*slab(0))
        mid = tail = None
        outs = []
        for i in range(ns):
            nxt = (lambda j=i + 1: fwd(*slab(j))) if i + 1 < ns else None
            ex, follow = self._fold_exchange(step, cur, interleave=nxt)
            folded = self._permuted(step, ex)
            cur = follow

            def kern(f=folded, lo=i * stride, hi=(i + 1) * stride):
                return kernel(f[0], f[1], lo, hi)

            if mid is None:
                mid = kern()            # pipeline fill: slab 0's kernel
                continue

            def thunk(k=kern, t=tail):
                return k(), (inv(*t) if t is not None else None)
            (ur, ui), (mid, fin) = self._unfold_exchange(step, mid,
                                                         interleave=thunk)
            if fin is not None:
                outs.append(fin)
            tail = (ur, ui)
        # drain: the last kernel result unfolds over slab ns−2's inverse
        # butterflies, then the final slab's butterflies run exposed
        thunk = (lambda t=tail: inv(*t)) if tail is not None else None
        (ur, ui), fin = self._unfold_exchange(step, mid, interleave=thunk)
        if fin is not None:
            outs.append(fin)
        outs.append(inv(ur, ui))
        return _cat(outs, axis)


# ---------------------------------------------------------------------------
# pallas ring: the same schedule through the NIC engine
# ---------------------------------------------------------------------------

@_register
class PallasRingEngine(OverlapRingEngine):
    """The overlapped ring with its transport lowered to the NIC engine of
    :mod:`repro_torch.kernels.ring_rdma` (paper §4.2).

    When the phase butterflies are the radix-2 c2c engine (backend
    ``"pallas"``, a ``c2c`` CommStep) and the wire fuses a payload, they
    run as the exchange's payload (:func:`ring_rdma.ring_payload`) between
    a round's send and its wait; otherwise the overlapped-ring schedule of
    the superclass runs on the same transport.
    """

    name = "pallas_ring"

    # ---- the NIC transport hooks -----------------------------------------
    def _transport(self, arrs, wire, **kw):
        """The exchange this engine's transport lowers to — the one method
        ``bidi_ring`` overrides."""
        return ring_rdma.ring_exchange_rdma(arrs, wire, **kw)

    def _exchange(self, arrs, step, **kw):
        """Counted transport: every exchange — relayouts, overlapped phases
        and fused payloads — goes through here."""
        self._count_rounds(step)
        return self._transport(arrs, self._wire(step, arrs[0].device), **kw)

    # ---- payload fusion --------------------------------------------------
    def _fusable(self, step: dec.CommStep, pair) -> bool:
        """When the payload kernel reproduces the phase compute: the plan's
        1D engine is the radix-2 kernel, the step wraps a plain c2c
        transform (the r2c X phase pads/packs), and the wire of the first
        stage (the innermost mesh axis), which carries the payload, fuses."""
        wires = self._wire(step, pair[0].device)
        return (wires is not None and wires[-1].fuses and self.backend == "pallas"
                and step.c2c and ring_rdma.fusable_payload(pair))

    def run_fold(self, step: dec.CommStep, compute, arrs):
        if not self._fusable(step, tuple(arrs[:2])):
            return super().run_fold(step, compute, arrs)
        axis, ns, _, slab = self._slabbing(step, arrs)
        cur = compute(*slab(0))
        outs = []
        for i in range(ns):
            payload = slab(i + 1) if i + 1 < ns else None
            ex, follow = self._fold_exchange(step, cur, payload=payload)
            outs.append(self._permuted(step, ex))
            cur = follow
        return _cat(outs, axis)

    def run_unfold(self, step: dec.CommStep, compute, arrs):
        if not self._fusable(step, tuple(arrs[:2])):
            return super().run_unfold(step, compute, arrs)
        axis, ns, _, slab = self._slabbing(step, arrs)
        outs = []
        prev = None
        for i in range(ns):
            ex, done = self._unfold_exchange(step, slab(i), payload=prev,
                                             inverse=True)
            if done is not None:
                outs.append(done)
            prev = (ex[0], ex[1])
        outs.append(compute(*prev))
        return _cat(outs, axis)

    def run_roundtrip(self, step: dec.CommStep, fwd, kernel, inv, arrs, *,
                      diag=None):
        """Slab k+1's forward butterflies ride slab k's fold exchange as
        payload, and slab k's whole spectral middle (forward butterflies,
        diagonal multiply, inverse) rides slab k−1's unfold exchange as a
        roundtrip payload; the inverse butterflies after each unfold run
        outside.  Needs the raw planar multiplier ``diag``."""
        if (diag is None or not self._fusable(step, tuple(arrs[:2]))
                or not ring_rdma.fusable_payload((diag[0], diag[0]))):
            return super().run_roundtrip(step, fwd, kernel, inv, arrs, diag=diag)
        axis, ns, stride, slab = self._slabbing(step, arrs)
        dr, di = diag
        if di is None:
            di = torch.zeros_like(dr)
        daxis = dr.dim() + step.slab_offset

        def diag_slab(i):
            return (dr.narrow(daxis, i * stride, stride),
                    di.narrow(daxis, i * stride, stride))

        cur = fwd(*slab(0))
        mid = None
        outs = []
        for i in range(ns):
            payload = slab(i + 1) if i + 1 < ns else None
            ex, follow = self._fold_exchange(step, cur, payload=payload)
            folded = self._permuted(step, ex)
            cur = follow
            if mid is None:
                mid = kernel(folded[0], folded[1], 0, stride)  # fill
                continue
            # slab i−1's unfold carries slab i's whole middle
            ex2, mid = self._unfold_exchange(step, mid, payload=folded,
                                             diag=diag_slab(i))
            outs.append(inv(ex2[0], ex2[1]))
        ex2, _ = self._unfold_exchange(step, mid)
        outs.append(inv(ex2[0], ex2[1]))
        return _cat(outs, axis)


# ---------------------------------------------------------------------------
# bidirectional ring: both ring directions per round (two NICs, Fig. 5.9)
# ---------------------------------------------------------------------------

@_register
class BidiRingEngine(PallasRingEngine):
    """The NIC engine driven over both ring directions at once (Fig. 5.9):
    round r ships block me+r one way and block me−r the other, so an
    exchange takes ⌈(P−1)/2⌉ rounds; an even ring ships the shared farthest
    block clockwise only."""

    name = "bidi_ring"

    wire_rounds = staticmethod(tr.bidi_rounds)

    def _transport(self, arrs, wire, **kw):
        return ring_rdma.ring_exchange_bidi_rdma(arrs, wire, **kw)


ENGINE_NAMES = tuple(ENGINES)
