"""Network topology characterization (paper §3.2.6, §5.5) — port of
``repro.core.topology`` over the port's perf model.

The 2D processor grid puts X↔Y traffic on rows and Y↔Z traffic on columns —
"rows and columns never exchange data traffic and can live on separated
networks". This module sizes those networks for both fabrics of the thesis
and answers the scalability question of Figs 5.11/5.12.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import perfmodel as pm
from repro_torch.core.engine_spec import EngineSpec

LINK_CAPS_GBPS = (100.0, 200.0, 400.0)      # thesis reference lines
FREQS_MHZ = (180.0, 250.0, 380.0)           # slow / standard / very fast engine

#: TransposeEngine → fabric it must be sized for: the switched engine needs
#: the full-bisection row/column switches of Fig. 5.10; every ring engine
#: (plain torus, the compute-overlapped ring, the RDMA ring, and the
#: bidirectional two-NIC ring) rides the 2D torus links of Fig. 5.9 —
#: overlap and direction change *when* blocks move, not how many links
#: exist (the torus node already owns both ±u links the bidi ring drives).
ENGINE_FABRIC = pm.ENGINE_FABRIC


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    """Sizing of one fabric choice for a √P×√P grid.

    ``engine``/``chunks`` are filled by :meth:`for_spec`: the engine the
    fabric serves and — when the problem size ``n`` is known — the
    engine-aware optimal slab count from ``perfmodel.optimal_chunks``
    (finer slabs need no extra links, but they decide how many messages
    the NICs must post per fold, which is what the per-engine message
    overhead of the chunk model prices).
    """
    topology: str           # "switched" | "torus"
    p: int
    r: int
    f_mhz: float
    engine: str = ""        # TransposeEngine this fabric is sized for
    chunks: int = 0         # model-optimal slab count (0 = problem unknown)

    @classmethod
    def for_spec(cls, spec: EngineSpec, p: int, r: int, f_mhz: float,
                 *, n=None, mu: int = 1, pu: int = 0, pv: int = 0,
                 pu_axes=None, pv_axes=None) -> "NetworkPlan":
        """Fabric sizing for an :class:`~repro_torch.core.engine_spec.EngineSpec`.

        With a problem size ``n`` (int or (nx, ny, nz)), the plan also
        carries the engine-aware optimal ``chunks`` — the slab count the
        NIC schedule should run at on this fabric. Pass the actual pencil
        grid via ``pu``/``pv`` (must multiply to ``p``); by default the
        closest-to-square factorization of ``p`` is used (exactly √P×√P
        when ``p`` is a perfect square, e.g. 8 → 4×2). On ≥2D meshes the
        per-mesh-axis factorizations ``pu_axes``/``pv_axes`` price each
        staged per-axis ring round separately.
        """
        topo = spec.fabric
        if pu or pv:
            if pu * pv != p:
                raise ValueError(f"pu*pv must equal p, got {pu}x{pv} != {p}")
        else:
            pv = next(q for q in range(max(int(math.isqrt(p)), 1), 0, -1)
                      if p % q == 0)
            pu = p // pv
        chunks = 0
        if n is not None:
            chunks = pm.optimal_chunks(n, pu, pv, spec=spec, mu=mu,
                                       r=r, f_hz=f_mhz * 1e6,
                                       pu_axes=pu_axes, pv_axes=pv_axes)
        return cls(topology=topo, p=p, r=r, f_mhz=f_mhz, engine=spec.engine,
                   chunks=chunks)

    @property
    def message_overhead_s(self) -> float:
        """Exposed per-message cost of the engine this plan serves (falls
        back to the fabric's serial engine when built without one). Uses
        the measured value when a ``repro_torch.tuning.calibrate`` run is active
        on this substrate, else the built-in prior."""
        return pm.message_overhead_s(self.engine or self.topology)

    @property
    def nics_per_node(self) -> int:
        """Fig. 5.9/5.10: 4 links for the torus, 2 for the switched grid."""
        return 4 if self.topology == "torus" else 2

    @property
    def required_bw_bytes_s(self) -> float:
        fn = pm.b_net_switched if self.topology == "switched" else pm.b_net_torus
        return fn(self.p, self.r, self.f_mhz * 1e6)

    @property
    def required_bw_gbit_s(self) -> float:
        return self.required_bw_bytes_s * 8.0 / 1e9

    def fits(self, link_gbps: float) -> bool:
        return self.required_bw_gbit_s <= link_gbps

    @property
    def n_switches(self) -> int:
        """2·√P row/column switches for the switched mesh, 0 for the torus."""
        return 0 if self.topology == "torus" else 2 * int(math.sqrt(self.p))


def bandwidth_curves(topology: str, r_values=(1, 2, 4), freqs_mhz=FREQS_MHZ,
                     sqrt_p_values=range(2, 33)):
    """The curves of Fig. 5.11 (switched) / Fig. 5.12 (torus): required
    network bandwidth (Gbit/s) vs grid side √P, per (R, f)."""
    curves = {}
    for r in r_values:
        for f in freqs_mhz:
            curves[(r, f)] = [
                (q, NetworkPlan(topology, q * q, r, f).required_bw_gbit_s)
                for q in sqrt_p_values
            ]
    return curves


def scalability_summary(link_gbps: float = 200.0):
    """The thesis' conclusion quantified: torus is fine for √P ≤ 4; the
    switched fabric scales to √P ≤ 32 (32-port full-bisection switches)."""
    out = {}
    for topo in ("switched", "torus"):
        for r in (1, 2, 4):
            for f in FREQS_MHZ:
                out[(topo, r, f)] = pm.max_scalable_p(
                    r, f * 1e6, link_gbps * 1e9, topology=topo, sq_max=32)
    return out
