"""Enumeration of the valid ``FFT3DPlan`` configuration space — port of
``repro.tuning.space`` over the port's chunk model."""

from __future__ import annotations

import dataclasses

from repro_torch.core.engine_spec import EngineSpec
from repro_torch.core.perfmodel import ENGINE_FABRIC, chunk_candidates
from repro_torch.kernels.ref import is_pow2

CHUNK_CHOICES = (2, 4, 8)       # legacy engine-blind slab counts (no-comm)
ALL_BACKENDS = ("jnp", "ref", "pallas", "mxu")
ALL_ENGINES = tuple(ENGINE_FABRIC)  # kept in sync with core.comm.ENGINE_NAMES


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the plan space — exactly the tunable ``make_fft3d`` knobs."""

    backend: str = "jnp"
    schedule: str = "sequential"
    chunks: int = 1
    comm_engine: str = "switched"
    vector_mode: str = "streaming"
    r2c_packed: bool = False
    fused_roundtrip: bool = False

    @property
    def net(self) -> str:
        """The §5.5 fabric the engine runs on (legacy knob name)."""
        return ENGINE_FABRIC[self.comm_engine]

    @property
    def name(self) -> str:
        sched = "seq" if self.schedule == "sequential" else f"pipe{self.chunks}"
        bits = [self.backend, sched, self.comm_engine, self.vector_mode]
        if self.r2c_packed:
            bits.append("packed")
        if self.fused_roundtrip:
            bits.append("fused")
        return "/".join(bits)

    def config(self) -> dict:
        cfg = dataclasses.asdict(self)
        cfg["net"] = self.net  # derived fabric, kept for older readers
        return cfg

    @classmethod
    def from_config(cls, cfg: dict) -> "Candidate":
        cfg = normalize_config(cfg)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in fields})

    def spec(self, real: bool = False) -> EngineSpec:
        """The :class:`EngineSpec` this candidate configures."""
        return EngineSpec(engine=self.comm_engine, backend=self.backend,
                          schedule=self.schedule, chunks=self.chunks,
                          real=real, r2c_packed=self.r2c_packed,
                          vector_mode=self.vector_mode,
                          fused_roundtrip=self.fused_roundtrip)

    @classmethod
    def from_spec(cls, spec: EngineSpec) -> "Candidate":
        return cls(backend=spec.backend, schedule=spec.schedule,
                   chunks=spec.chunks, comm_engine=spec.engine,
                   vector_mode=spec.vector_mode, r2c_packed=spec.r2c_packed,
                   fused_roundtrip=spec.fused_roundtrip)


def normalize_config(cfg: dict) -> dict:
    """Copy of ``cfg`` with legacy knobs mapped onto the current ones.

    The one place that knows pre-engine configs (``net`` only, e.g. cache
    entries or bench rows written before the TransposeEngine layer) name
    their engine through the fabric knob.
    """
    cfg = dict(cfg)
    if not cfg.get("comm_engine") and "net" in cfg:
        cfg["comm_engine"] = cfg["net"]
    return cfg


DEFAULT_CANDIDATE = Candidate()  # the hardcoded status quo every caller used


def candidate_space(n, pu: int, pv: int, *, real: bool = False,
                    components: int = 0, backends=None, fused: bool = False,
                    pu_axes=None, pv_axes=None) -> list[Candidate]:
    """All valid candidates for the problem.

    Validity rules:

    * ``ref``/``pallas``/``mxu`` are radix-2 / four-step engines — power-of-two
      axis lengths only (``jnp`` delegates to ``torch.fft``'s general FFT).
    * the ring engines (``torus``/``overlap_ring``/``pallas_ring``) are only
      distinct from ``switched`` when a fold actually communicates
      (Pu > 1 or Pv > 1).
    * pipelined slab counts come from the engine-aware chunk model
      (``perfmodel.chunk_candidates``): each engine contributes its model
      optimum and the neighboring powers of two instead of an engine-blind
      global list.
    * on ≥2D meshes the per-mesh-axis factorizations ``pu_axes``/``pv_axes``
      (e.g. ``PencilGrid.u_sizes``) feed the chunk model, which prices each
      staged per-axis ring round instead of one flat P-rank ring.
    * ``vector_mode`` only matters for μ-component fields (``components>0``).
    * ``r2c_packed`` needs a real transform with even power-of-two Nx.
    * ``fused=True`` (solver-step tuning of a diagonal spectral operator)
      additionally enumerates each candidate with the fused-roundtrip
      executor on — only meaningful for workloads stepping through
      ``fft3d.spectral_roundtrip_local``, so off by default.
    """
    nx, ny, nz = (n, n, n) if isinstance(n, int) else tuple(n)
    pow2 = all(is_pow2(d) for d in (nx, ny, nz))
    if backends is None:
        backends = [b for b in ALL_BACKENDS if b == "jnp" or pow2]
    engines = ALL_ENGINES if (pu > 1 or pv > 1) else ("switched",)
    vmodes = ("streaming", "parallel") if components else ("streaming",)
    packed_opts = (False, True) if (real and pow2 and nx % 2 == 0) else (False,)
    fused_opts = (False, True) if fused else (False,)

    out = []
    for backend in backends:
        for engine in engines:
            chunks_for = chunk_candidates(n, pu, pv, engine,
                                          backend=backend, mu=max(components, 1),
                                          pu_axes=pu_axes, pv_axes=pv_axes)
            schedules = [("sequential", 1)] + [("pipelined", c)
                                               for c in chunks_for]
            for schedule, chunks in schedules:
                for vm in vmodes:
                    for packed in packed_opts:
                        for fr in fused_opts:
                            out.append(Candidate(
                                backend=backend, schedule=schedule,
                                chunks=chunks, comm_engine=engine,
                                vector_mode=vm, r2c_packed=packed,
                                fused_roundtrip=fr))
    return out
