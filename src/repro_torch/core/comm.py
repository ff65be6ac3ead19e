"""TransposeEngine — the fold-communication layer (paper §4.2–4.3).

Port of ``repro.core.comm`` for one rank.  The five registered engines keep
the reference's names (``switched``, ``torus``, ``overlap_ring``,
``pallas_ring``, ``bidi_ring``) so a reference plan config selects the same
one.  On a 1×1 grid none of them communicates: every fold is a local
permute, and all five run the base slab schedule below, exactly as the
reference's ``p <= 1`` branches do.  Their multi-rank schedules come with
``torch.distributed`` (ROADMAP Queue 1 item 5).

The scheduling contract is the reference's: ``run_fold`` (butterflies then
fold), ``run_unfold`` (unfold then butterflies) and ``run_roundtrip`` (fold,
folded-pencil kernel, unfold, slab by slab), each over one
:class:`~repro_torch.core.decomposition.CommStep`.  The slab boundaries are
the reference's too, because they decide which rows a
``DiagonalKernel.apply(lo, hi)`` slices.
"""

from __future__ import annotations

import torch

from repro_torch.core import decomposition as dec
from repro_torch.core import transpose as tr
from repro_torch.core.engine_spec import EngineSpec


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

    # ---- relayout primitives (pure data movement) ------------------------
    def fold_step(self, step: dec.CommStep, a: torch.Tensor) -> torch.Tensor:
        """One CommStep's fold: block exchange over the step's grid
        dimension, then the step's local permute (materialised)."""
        d = a.dim()
        b = tr.all_to_all_blocks(a, self.grid.dim_ranks(step.grid_dim),
                                 split_axis=d + step.split_offset,
                                 concat_axis=d + step.concat_offset,
                                 mode=self.mode)
        return tr.permute_last3(b, step.permute).contiguous()

    def unfold_step(self, step: dec.CommStep, a: torch.Tensor) -> torch.Tensor:
        """Inverse relayout: the step's permute, then the inverse exchange."""
        d = a.dim()
        b = tr.permute_last3(a, step.permute).contiguous()
        return tr.all_to_all_blocks(b, self.grid.dim_ranks(step.grid_dim),
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
        return tuple(torch.cat([o[k] for o in outs], dim=axis)
                     for k in range(len(outs[0])))


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


@_register
class OverlapRingEngine(TorusEngine):
    """The ring with the 1D FFT between its rounds (Fig. 4.3)."""

    name = "overlap_ring"


@_register
class PallasRingEngine(OverlapRingEngine):
    """The overlapped ring as an in-kernel exchange (the paper's NIC)."""

    name = "pallas_ring"


@_register
class BidiRingEngine(PallasRingEngine):
    """The ring over both torus directions, ⌈(P−1)/2⌉ rounds."""

    name = "bidi_ring"


ENGINE_NAMES = tuple(ENGINES)
