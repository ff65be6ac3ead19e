"""EngineSpec — the one way to say *how* the transposes run.

Port of ``repro.core.engine_spec`` with the same names and validation, so a
reference ``plan_cfg`` means the same thing here.  Backends:

* ``"pallas"`` — the hand-written radix-2 CUDA kernel
  (:mod:`repro_torch.kernels.fft_radix2`); the name is the reference's;
* ``"ref"``    — its plain PyTorch version (:mod:`repro_torch.kernels.ref`);
* ``"jnp"``    — ``torch.fft``, the library FFT (the reference's XLA FFT);
* ``"mxu"``    — the hand-written four-step FFT CUDA kernel, its products on
  the FP64 tensor cores in f64 (:mod:`repro_torch.kernels.fft_mxu`).
"""

from __future__ import annotations

import dataclasses

# Which network fabric each comm engine presumes (paper §4.2/§5.5).
ENGINE_FABRIC = {
    "switched": "switched",
    "torus": "torus",
    "overlap_ring": "torus",
    "pallas_ring": "torus",
    "bidi_ring": "torus",
}

SCHEDULES = ("sequential", "pipelined")
VECTOR_MODES = ("streaming", "parallel")
BACKENDS = ("jnp", "ref", "pallas", "mxu")


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """How the transposes (and the compute between them) run.

    ``engine``      registered comm engine name (``ENGINE_FABRIC`` keys)
    ``backend``     1D-FFT compute backend (``jnp``/``ref``/``pallas``/``mxu``)
    ``schedule``    ``sequential`` or ``pipelined`` (chunked slabs)
    ``chunks``      pipeline depth; forced to 1 under ``sequential``
    ``real``        r2c data model (real input, Hermitian spectrum)
    ``r2c_packed``  pack the real transform into the half-spectrum layout
    ``vector_mode`` multi-component transforms: ``streaming`` or ``parallel``
    ``fused_roundtrip``  run the Y↔Z roundtrip of diagonal spectral
                    operators slab by slab instead of as three phases
    """

    engine: str = "switched"
    backend: str = "jnp"
    schedule: str = "sequential"
    chunks: int = 1
    real: bool = False
    r2c_packed: bool = False
    vector_mode: str = "streaming"
    fused_roundtrip: bool = False

    def __post_init__(self):
        if self.engine not in ENGINE_FABRIC:
            raise ValueError(f"unknown comm engine {self.engine!r}; "
                             f"have {sorted(ENGINE_FABRIC)}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, "
                             f"got {self.schedule!r}")
        if self.vector_mode not in VECTOR_MODES:
            raise ValueError(f"vector_mode must be one of {VECTOR_MODES}, "
                             f"got {self.vector_mode!r}")
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if self.schedule == "sequential" and self.chunks != 1:
            object.__setattr__(self, "chunks", 1)

    @property
    def fabric(self) -> str:
        """The network fabric this engine presumes (``switched``/``torus``)."""
        return ENGINE_FABRIC[self.engine]

    def replace(self, **changes) -> "EngineSpec":
        return dataclasses.replace(self, **changes)

