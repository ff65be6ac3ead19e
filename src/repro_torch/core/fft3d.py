"""3D FFT over the pencil pipeline — port of ``repro.core.fft3d``.

The transpose method (§3.2.4): local X FFT → X↔Y fold → local Y FFT → Y↔Z
fold → local Z FFT, walked over the plan's :class:`CommDAG` through a
:class:`~repro_torch.core.comm.TransposeEngine`.  ``schedule="pipelined"``
cuts each phase into ``chunks`` slabs along the axis its fold leaves
untouched; ``vector_mode`` picks how μ-component fields go through
(``parallel``: one pass over the leading component axis; ``streaming``: one
transform per component).

:func:`spectral_roundtrip_local` runs forward FFT → diagonal k-space
multiply (:class:`DiagonalKernel`) → inverse FFT; with the plan's
``fused_roundtrip`` knob on, the Y↔Z phase pair runs slab by slab through
``run_roundtrip``.

The "local" functions run on this rank's pencil; on one rank every fold is
a local permute and they are the whole transform.  On a grid of more ranks
each rank process (:func:`repro_torch.dist.run_ranks`) calls them on its
own block, where the reference runs them inside ``shard_map``;
:func:`scatter_pencil` and :func:`gather_pencil` cut a global pencil into
the blocks and put it back together on rank 0.  :func:`make_fft3d` wraps
the local functions as entry points on a device.

Observability, with the reference's names: each fold phase runs in a
``trace/fft3d.<phase>`` span (``fold_xy``, ``fold_yz``, ``unfold_yz``,
``unfold_xy``, ``roundtrip_yz``) that times the host's launches of the phase
and waits for nothing, annotated with the perf model's wire time of the
phase (``model_wire_us``); :func:`make_fft3d`'s entry points are
``dispatch/fft3d.fwd`` and ``dispatch/fft3d.inv`` spans, which wait for
the card, annotated with the model's time of the transform
(``model_predicted_us``).  Left out: the reference's
``fft3d.retraces.*`` counters, which count JAX retraces: the port traces
nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch
import torch.distributed as tdist
import torch.nn.functional as F

from repro_torch import dist, obs
from repro_torch.core import comm, precision
from repro_torch.core import perfmodel as pm
from repro_torch.core.decomposition import CommDAG, PencilGrid, fft3d_dag
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

Schedule = Literal["sequential", "pipelined"]
VectorMode = Literal["parallel", "streaming"]


@dataclasses.dataclass(frozen=True)
class FFT3DPlan:
    n: tuple[int, int, int]
    grid: PencilGrid
    real: bool = False
    backend: str = "jnp"             # "pallas" | "mxu" | "ref" | "jnp"
    schedule: Schedule = "sequential"
    chunks: int = 1                  # pipelined slab count (1 = sequential)
    net: str = "switched"            # fabric: "switched" | "torus" (derived)
    r2c_packed: bool = False         # beyond-paper packed real FFT
    comm_engine: str = ""            # "" -> engine named by ``net``
    dtype: str = ""                  # "" -> caller-supplied tensors decide
    fused_roundtrip: bool = False    # slab-streamed diagonal roundtrips
    _engine: object = dataclasses.field(default=None, init=False,
                                        repr=False, compare=False)

    def __post_init__(self):
        self.grid.validate(self.n)
        kops.check_backend(self.backend)
        if self.dtype:
            canonical = precision.require_dtype(self.dtype, who="FFT3DPlan")
            object.__setattr__(self, "dtype", canonical.name)
        if self.schedule == "sequential":
            object.__setattr__(self, "chunks", 1)
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        engine = self.comm_engine or self.net
        if engine not in comm.ENGINES:
            raise ValueError(f"unknown comm_engine {engine!r}; "
                             f"have {sorted(comm.ENGINES)}")
        object.__setattr__(self, "comm_engine", engine)
        object.__setattr__(self, "net", comm.engine_fabric(engine))

    def spec(self) -> EngineSpec:
        """This plan's engine configuration as one :class:`EngineSpec`."""
        return EngineSpec(engine=self.comm_engine, backend=self.backend,
                          schedule=self.schedule, chunks=self.chunks,
                          real=self.real, r2c_packed=self.r2c_packed,
                          fused_roundtrip=self.fused_roundtrip)

    @classmethod
    def from_spec(cls, n, grid: PencilGrid, spec: EngineSpec,
                  dtype: str = "") -> "FFT3DPlan":
        return cls(n=tuple(n), grid=grid, real=spec.real,
                   backend=spec.backend, schedule=spec.schedule,
                   chunks=spec.chunks, r2c_packed=spec.r2c_packed,
                   comm_engine=spec.engine, dtype=dtype,
                   fused_roundtrip=spec.fused_roundtrip)

    def dag(self) -> CommDAG:
        return fft3d_dag(self.real)

    def engine(self) -> comm.TransposeEngine:
        """The plan's engine, built once (its ``exchange_rounds`` counts
        over every transform of the plan)."""
        if self._engine is None:
            object.__setattr__(self, "_engine",
                               comm.build_engine(self.spec(), self.grid))
        return self._engine

    @property
    def kx(self) -> int:
        """Spectral X length: padded N/2+1 bins if real, else Nx."""
        return self.grid.padded_r2c_len(self.n[0]) if self.real else self.n[0]

    @property
    def kx_keep(self) -> int:
        return self.n[0] // 2 + 1 if self.real else self.n[0]


def _fftx(plan, xr, xi):
    if plan.real:
        yr, yi = kops.rfft1d(xr, axis=-1, backend=plan.backend,
                             packed=plan.r2c_packed)
        pad = plan.kx - plan.kx_keep
        if pad:
            yr, yi = F.pad(yr, (0, pad)), F.pad(yi, (0, pad))
        return yr, yi
    return kops.fft1d(xr, xi, axis=-1, backend=plan.backend)


def _ifftx(plan, xr, xi):
    if plan.real:
        xr = xr[..., : plan.kx_keep]
        xi = xi[..., : plan.kx_keep]
        return kops.irfft1d(xr, xi, n=plan.n[0], axis=-1, backend=plan.backend)
    return kops.fft1d(xr, xi, axis=-1, backend=plan.backend, inverse=True)


def _ifftx_phase(plan):
    """The inverse X butterflies as an unfold-phase compute (a 1-tuple for
    the real data model, whose result is one array)."""
    def butterflies_x_inv(ur, ui):
        if plan.real:
            return (_ifftx(plan, ur, ui),)
        return _ifftx(plan, ur, ui)
    return butterflies_x_inv


# ---------------------------------------------------------------------------
# forward / inverse
# ---------------------------------------------------------------------------

def _phase_span(plan: FFT3DPlan, name: str, dim: str):
    """A ``trace/...`` span around one fold phase over grid dimension
    ``dim``, annotated with the perf model's wire time of that phase (the
    shared no-op span while obs is disabled)."""
    if not obs.is_enabled():
        return obs.NULL_SPAN
    g = plan.grid
    sizes = g.dim_sizes(dim)
    wire_us = pm.estimate_fold_seconds(
        plan.n, g.pu, g.pv, sizes, comm_engine=plan.comm_engine) * 1e6
    return obs.span(name, engine=plan.comm_engine, grid_dim=dim,
                    dim_sizes=list(sizes), model_wire_us=round(wire_us, 3))


def fft3d_local(plan: FFT3DPlan, xr, xi=None):
    """Forward 3D FFT of the local pencil (any leading axes).

    In : X-pencil ``(..., Ny/Pu, Nz/Pv, Nx)`` (xi may be None for real input)
    Out: Z-pencil ``(..., Kx/Pu, Ny/Pv, Nz)`` planar complex, natural order.
    """
    eng = plan.engine()
    dag = plan.dag()
    if xi is None:
        xi = torch.zeros_like(xr)
    with _phase_span(plan, "trace/fft3d.fold_xy", "u"):
        yr, yi = eng.run_fold(dag.step("xy"), lambda cr, ci: _fftx(plan, cr, ci),
                              (xr, xi))

    def butterflies_y(cr, ci):
        return kops.fft1d(cr, ci, axis=-1, backend=plan.backend)

    with _phase_span(plan, "trace/fft3d.fold_yz", "v"):
        yr, yi = eng.run_fold(dag.step("yz"), butterflies_y, (yr, yi))
    return kops.fft1d(yr, yi, axis=-1, backend=plan.backend)


def ifft3d_local(plan: FFT3DPlan, kr, ki):
    """Inverse 3D FFT: Z-pencil spectral in, X-pencil physical out.

    Returns a real tensor if ``plan.real`` else a planar (re, im) pair.
    """
    eng = plan.engine()
    dag = plan.dag()
    yr, yi = kops.fft1d(kr, ki, axis=-1, backend=plan.backend, inverse=True)

    def butterflies_y_inv(ur, ui):
        return kops.fft1d(ur, ui, axis=-1, backend=plan.backend, inverse=True)

    with _phase_span(plan, "trace/fft3d.unfold_yz", "v"):
        yr, yi = eng.run_unfold(dag.step("yz"), butterflies_y_inv, (yr, yi))
    with _phase_span(plan, "trace/fft3d.unfold_xy", "u"):
        out = eng.run_unfold(dag.step("xy"), _ifftx_phase(plan), (yr, yi))
    return out[0] if plan.real else out


# ---------------------------------------------------------------------------
# spectral roundtrip (forward FFT → diagonal multiply → inverse FFT)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiagonalKernel:
    """A spectral operator that is pointwise-diagonal in k-space.

    ``dr``/``di`` hold the real/imaginary parts of the multiplier on the
    local Z-pencil spectrum, shape ``(Kx/Pu, Ny/Pv, Nz)`` (or broadcastable
    to it); ``di=None`` marks a purely real multiplier.
    """

    dr: torch.Tensor
    di: torch.Tensor | None = None

    def apply(self, kr, ki, lo: int | None = None, hi: int | None = None):
        """Multiply the planar spectrum by the kernel; ``[lo, hi)`` selects
        the kx rows of a slab (slab axis −3 of the Z-pencil)."""
        dr, di = self.dr, self.di
        if lo is not None:
            axis = dr.dim() - 3
            dr = dr.narrow(axis, lo, hi - lo)
            if di is not None:
                di = di.narrow(axis, lo, hi - lo)
        if di is None:
            return kr * dr, ki * dr
        return kr * dr - ki * di, kr * di + ki * dr

    def arrays(self):
        """The raw planar multiplier pair (``di`` may be None)."""
        return self.dr, self.di


def spectral_roundtrip_local(plan: FFT3DPlan, kernel: DiagonalKernel,
                             xr, xi=None):
    """Forward 3D FFT → diagonal k-space multiply → inverse 3D FFT.

    With ``plan.fused_roundtrip`` off this composes ``fft3d_local`` →
    ``kernel.apply`` → ``ifft3d_local``.  With it on, the Y↔Z phase pair
    (Y butterflies, yz fold, Z-FFT, multiply, inverse Z-FFT, yz unfold,
    inverse Y butterflies) runs per kx-slab through ``run_roundtrip``.
    In/out: X-pencil (a real tensor comes back when ``plan.real``).
    """
    if not plan.fused_roundtrip:
        kr, ki = fft3d_local(plan, xr, xi)
        kr, ki = kernel.apply(kr, ki)
        return ifft3d_local(plan, kr, ki)

    eng = plan.engine()
    dag = plan.dag()
    if xi is None:
        xi = torch.zeros_like(xr)
    with _phase_span(plan, "trace/fft3d.fold_xy", "u"):
        yr, yi = eng.run_fold(dag.step("xy"), lambda cr, ci: _fftx(plan, cr, ci),
                              (xr, xi))

    def butterflies_y(cr, ci):
        return kops.fft1d(cr, ci, axis=-1, backend=plan.backend)

    def butterflies_y_inv(ur, ui):
        return kops.fft1d(ur, ui, axis=-1, backend=plan.backend, inverse=True)

    def middle(zr, zi, lo, hi):
        # everything at the Z pencil, for kx rows [lo, hi)
        zr, zi = kops.fft1d(zr, zi, axis=-1, backend=plan.backend)
        zr, zi = kernel.apply(zr, zi, lo, hi)
        return kops.fft1d(zr, zi, axis=-1, backend=plan.backend, inverse=True)

    with _phase_span(plan, "trace/fft3d.roundtrip_yz", "v"):
        yr, yi = eng.run_roundtrip(dag.step("yz"), butterflies_y, middle,
                                   butterflies_y_inv, (yr, yi),
                                   diag=kernel.arrays())
    with _phase_span(plan, "trace/fft3d.unfold_xy", "u"):
        out = eng.run_unfold(dag.step("xy"), _ifftx_phase(plan), (yr, yi))
    return out[0] if plan.real else out


def fft3d_vector_local(plan: FFT3DPlan, xr, xi=None,
                       vector_mode: VectorMode = "streaming"):
    """μ-component transform; axis −4 of ``xr`` is the component axis (any
    axes before it are lanes).

    ``parallel``  — one pass with the component axis live throughout;
    ``streaming`` — one transform per component c.
    """
    if vector_mode == "parallel":
        return fft3d_local(plan, xr, xi)
    xis = (None,) * xr.shape[-4] if xi is None else xi.unbind(-4)
    outs = [fft3d_local(plan, a, b) for a, b in zip(xr.unbind(-4), xis)]
    return (torch.stack([o[0] for o in outs], dim=-4),
            torch.stack([o[1] for o in outs], dim=-4))


def ifft3d_vector_local(plan: FFT3DPlan, kr, ki,
                        vector_mode: VectorMode = "streaming"):
    if vector_mode == "parallel":
        return ifft3d_local(plan, kr, ki)
    outs = [ifft3d_local(plan, a, b) for a, b in zip(kr.unbind(-4), ki.unbind(-4))]
    if plan.real:
        return torch.stack(outs, dim=-4)
    return (torch.stack([o[0] for o in outs], dim=-4),
            torch.stack([o[1] for o in outs], dim=-4))


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def scatter_pencil(x, grid: PencilGrid) -> torch.Tensor:
    """This rank's block of a global pencil (X-pencil ``(..., Ny, Nz, Nx)``
    or Z-pencil ``(..., Kx, Ny, Nz)``): axis −3 cut by ``u``, axis −2 by
    ``v``, as the reference's ``P(u, v, None)`` sharding does."""
    x = torch.as_tensor(x)
    u, v = grid.coords
    a = x.shape[-3] // grid.pu
    b = x.shape[-2] // grid.pv
    return x[..., u * a:(u + 1) * a, v * b:(v + 1) * b, :]


def gather_pencil(local: torch.Tensor, grid: PencilGrid):
    """The global pencil from every rank's block (:func:`scatter_pencil`'s
    inverse), on the CPU of rank 0; None on the other ranks.  Collective
    over the ranks (gloo on the host)."""
    if grid.p == 1:
        return local.detach().cpu()
    t = local.detach().to("cpu").contiguous()
    rank = dist.context().rank
    parts = [torch.empty_like(t) for _ in range(grid.p)] if rank == 0 else None
    tdist.gather(t, parts, dst=0)
    if rank != 0:
        return None
    a, b = t.shape[-3], t.shape[-2]
    out = torch.empty(t.shape[:-3] + (a * grid.pu, b * grid.pv, t.shape[-1]),
                      dtype=t.dtype)
    for r, part in enumerate(parts):
        u, v = dist.coords_of(r, grid.pv)
        out[..., u * a:(u + 1) * a, v * b:(v + 1) * b, :] = part
    return out


def make_fft3d(grid: PencilGrid, n, *, spec: EngineSpec | None = None,
               real: bool | None = None, components: int = 0,
               device="cuda", autotune: bool = False,
               tune_kwargs: dict | None = None):
    """Build ``(forward, inverse, plan)`` on ``device`` for this rank.

    Layout as in the reference, per rank: forward takes this rank's block
    of the X-pencil ``(Ny/Pu, Nz/Pv, Nx)`` (plus a leading component axis
    if ``components``) and returns its block of the Z-pencil spectrum
    ``(Kx/Pu, Ny/Pv, Nz)`` as a planar pair; inverse undoes it.  On a grid
    of more than one rank, call it in every rank process of
    :func:`repro_torch.dist.run_ranks` (the grid takes this rank's
    coordinates).  Inputs (tensors or numpy arrays) are moved to
    ``device``.  ``real`` describes the problem and overrides ``spec.real``
    when given.  ``forward`` and ``inverse`` are ``dispatch/fft3d.fwd`` and
    ``dispatch/fft3d.inv`` spans when obs is enabled, carrying the perf
    model's ``model_predicted_us``.

    ``autotune=True`` ignores the explicit engine configuration and
    instead sweeps the plan space for this ``(n, grid, real, components)``
    problem on ``device`` (see ``repro_torch.tuning``), reusing the
    persistent plan cache when a prior run already timed it.
    ``tune_kwargs`` forwards extra options to
    ``repro_torch.tuning.autotune`` (``cache_path``, ``max_candidates``,
    ``iters``, ``dtype``, ``fwd_weight``, ``inv_weight``, ...).
    """
    grid = dist.bind_grid(grid, "make_fft3d")
    dev = resolve_device(device)
    n = (n, n, n) if isinstance(n, int) else tuple(n)
    s = spec if spec is not None else EngineSpec()
    if real is not None:
        s = s.replace(real=bool(real))
    if autotune:
        from repro_torch.tuning import autotune as _autotune
        from repro_torch.tuning.space import Candidate
        result = _autotune(grid, n, real=s.real, components=components,
                           device=dev, **(tune_kwargs or {}))
        s = Candidate.from_config(result.best_config).spec(real=s.real)
    plan = FFT3DPlan.from_spec(n, grid, s)
    vector_mode = s.vector_mode

    def on_device(x):
        return None if x is None else torch.as_tensor(x, device=dev)

    def fwd(xr, xi=None):
        xr, xi = on_device(xr), on_device(xi)
        if components:
            return fft3d_vector_local(plan, xr, xi, vector_mode=vector_mode)
        return fft3d_local(plan, xr, xi)

    def inv(kr, ki):
        kr, ki = on_device(kr), on_device(ki)
        if components:
            return ifft3d_vector_local(plan, kr, ki, vector_mode=vector_mode)
        return ifft3d_local(plan, kr, ki)

    attrs = {
        "engine": plan.comm_engine, "n": list(n), "mesh": grid.mesh_label,
        "model_predicted_us": round(pm.estimate_plan_seconds(
            n, grid.pu, grid.pv, spec=s, mu=max(components, 1),
            pu_axes=grid.u_sizes, pv_axes=grid.v_sizes) * 1e6, 3),
    }
    return (obs.traced_call(fwd, "dispatch/fft3d.fwd", attrs),
            obs.traced_call(inv, "dispatch/fft3d.inv", attrs), plan)
