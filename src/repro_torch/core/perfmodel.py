"""The paper's analytic performance/resource model (Chapters 3–5) — port of
``repro.core.perfmodel``.

Every closed form of the reference, line for line (``tests/test_torch_perfmodel.py``
holds each function equal to the reference's under one calibration):

* Engine timing  — Eq. 5.2 (l_but), Eq. 5.3 (l_FFT), Eq. 3.11 (T_FFT),
  Eq. 3.12 (B_FFT), Eq. 5.4 (GFLOPS)          → Tables 5.1–5.6
* Architecture comparison (sequential / pipelined / parallel) — Eq. 4.4–4.17
  → Tables 4.1, 4.2
* Network required bandwidth — Eq. 5.5 (switched), Eq. 5.6 (torus)
  → Figs 5.11, 5.12
* Global 3D-FFT projection — Table 5.7 (with its 8 GiB HBM feasibility mask)

The paper's FPGA constants (``S_BYTES``, ``f_hz=180e6``, ``l_op``, the
VU37P's ``HBM_LIMIT_BYTES``) stay: they are the paper's analytic model.
What differs is the substrate: the three priors the autotuner ranks plans
with (``BACKEND_COMPUTE_WEIGHT``, ``ENGINE_MESSAGE_OVERHEAD_S``,
``LINK_BYTES_PER_S``) are H100 values, each derived in its comment, and a
measured calibration comes from :mod:`repro_torch.tuning.calibrate`.

Conventions: ``s`` = 8 bytes (one double); complex points are ``2s``;
GB/s figures are binary (GiB/s) to match the thesis tables; GFLOPS decimal.
"""

from __future__ import annotations

import dataclasses
import math

S_BYTES = 8               # double precision word (paper §3.2.5)
GIB = 2.0 ** 30
HBM_LIMIT_BYTES = 8 * GIB  # VU37P in-package HBM (paper §5.4)


# ---------------------------------------------------------------------------
# 1D engine model (paper §3.4, §5.1–5.3)
# ---------------------------------------------------------------------------

def l_butterfly(l_op: int) -> int:
    """Eq. 5.2 with l_A = l_B = l_C = l_op: l_but = 3·l_op + 4."""
    return 3 * l_op + 4


def l_fft_cycles(n: int, l_op: int, r: int = 1) -> int:
    """Eq. 5.3 generalized to R rows: the shuffle shift registers shrink by
    R (on-chip reorder memory ∝ N − 2R, §5.2), so
    l_FFT = (l_but + 1)·log2 N + N/(2R) − 1.

    Matches the latency columns of Tables 5.2 (R=1), 5.4 (R=2), 5.6 (R=4).
    """
    s = int(math.log2(n))
    return (l_butterfly(l_op) + 1) * s + n // (2 * r) - 1


def engine_latency_cycles(n: int, l_op: int, r: int = 1) -> int:
    """The 'latency cycles' column of Tables 5.2/5.4/5.6 (= l_FFT + 1; the
    thesis counts one extra output-registration cycle in the tables)."""
    return l_fft_cycles(n, l_op, r) + 1


def t_fft_seconds(n: int, r: int, l_op: int, f_hz: float) -> float:
    """Eq. 3.11: T_FFT = l_FFT + t_clk·N/(2R)."""
    return (l_fft_cycles(n, l_op, r) + n / (2 * r)) / f_hz


def b_fft_bytes_per_s(r: int, f_hz: float, s: int = S_BYTES) -> float:
    """Eq. 3.12: B_FFT = 4·s·R/t_clk — two complex words in+out per cycle/row."""
    return 4.0 * s * r * f_hz


def engine_gflops(n: int, r: int, f_hz: float) -> float:
    """Eq. 5.4: 10 FLOPs per butterfly × R rows × log2 N stages per cycle."""
    return 10.0 * r * math.log2(n) * f_hz / 1e9


@dataclasses.dataclass(frozen=True)
class EnginePoint:
    n: int
    r: int
    l_op: int
    f_mhz: float

    @property
    def latency_cycles(self) -> int:
        return engine_latency_cycles(self.n, self.l_op, self.r)

    @property
    def l_fft_us(self) -> float:
        return self.latency_cycles / self.f_mhz  # cycles / MHz = µs

    @property
    def t_fft_us(self) -> float:
        return t_fft_seconds(self.n, self.r, self.l_op, self.f_mhz * 1e6) * 1e6

    @property
    def b_fft_gib_s(self) -> float:
        return b_fft_bytes_per_s(self.r, self.f_mhz * 1e6) / GIB

    @property
    def gflops(self) -> float:
        return engine_gflops(self.n, self.r, self.f_mhz * 1e6)


# ---------------------------------------------------------------------------
# 3D architecture comparison (paper Ch. 4)
# ---------------------------------------------------------------------------

def t_tot_sequential(n: int, p: int, r: int, q: int, f_hz: float,
                     mu: int = 1, exact: bool = False,
                     l_dma: int = 0, l_comm: int = 0, l_op: int = 9) -> float:
    """Eq. 4.4 (exact) / Eq. 4.14 (asymptotic): sequential architecture."""
    if exact:
        cyc = (4 * l_dma + 3 * l_fft_cycles(n, l_op, r) + 3 * l_comm
               + n**3 / (2 * p * r * q)
               + 2 * (n**3 + 2 * n**2) / (4 * p * r * q))
        return mu * cyc / f_hz
    return 2.0 * mu * n**3 / (2 * p * r * q) / f_hz


def t_tot_pipelined(n: int, p: int, r: int, k: int, f_hz: float,
                    mu: int = 1) -> float:
    """Eq. 4.15: pipelined-streaming with doubled X engines (Q = 4k)."""
    return (mu + 1.0) * n**3 / (4 * p * r * k) / f_hz


def t_tot_parallel(n: int, p: int, r: int, f_hz: float, mu: int = 1) -> float:
    """Parallel vector processing: same time as sequential μ=1 (Table 4.1)."""
    return 2.0 * n**3 / (2 * p * r) / f_hz


def table_4_1(mu: int):
    """Architectural comparison at k=1, in the paper's normalized units
    (T_tot in t_clk·N³/2P ; B in 4s/t_clk ; M in sN³/P)."""
    return {
        "sequential": dict(T_tot=2 * mu, B=1, M=2, N_L_DMA=2, N_H_DMA=1, Q=1, N_NET=1),
        "pipelined": dict(T_tot=(mu + 1) / 2, B=1, M=2, N_L_DMA=4, N_H_DMA=2, Q=4, N_NET=2),
        "parallel": dict(T_tot=2, B=mu, M=2 * mu, N_L_DMA=2 * mu, N_H_DMA=mu, Q=mu, N_NET=mu),
    }


def table_4_2(mu: int):
    """Fixed Q=4 comparison (normalized units as above)."""
    return {
        "sequential": dict(T_tot=mu / 2.0, B=4, M=2),
        "pipelined": dict(T_tot=(mu + 1) / 2.0, B=1, M=2),
    }


def m_tot_sequential_bytes(n: int, p: int, s: int = S_BYTES) -> float:
    """Eq. 4.8: M = 2·V' = 2s(N³+2N²)/P."""
    return 2.0 * s * (n**3 + 2 * n**2) / p


def m_tot_pipelined_bytes(n: int, p: int, pu: int, s: int = S_BYTES) -> float:
    """Eq. 4.17 (streaming pipelined): 2s(N³+2N²)/P + 2sN²/Pu."""
    return 2.0 * s * (n**3 + 2 * n**2) / p + 2.0 * s * n**2 / pu


# ---------------------------------------------------------------------------
# Network required bandwidth (paper §5.5)
# ---------------------------------------------------------------------------

def b_net_switched(p: int, r: int, f_hz: float, s: int = S_BYTES) -> float:
    """Eq. 5.5: B = (4sR/t_clk)·(√P−1)/√P  [bytes/s]."""
    sq = math.sqrt(p)
    return b_fft_bytes_per_s(r, f_hz, s) * (sq - 1.0) / sq


def b_net_torus(p: int, r: int, f_hz: float, s: int = S_BYTES) -> float:
    """Eq. 5.6: B = (2sR/t_clk)·(√P−1)  [bytes/s] — multi-hop penalty."""
    return 2.0 * s * r * f_hz * (math.sqrt(p) - 1.0)


def max_scalable_p(r: int, f_hz: float, link_bits_per_s: float,
                   topology: str = "switched", sq_max: int = 1024) -> int:
    """Largest square grid P = q² whose required bandwidth fits the link."""
    fn = b_net_switched if topology == "switched" else b_net_torus
    best = 1
    for q in range(1, sq_max + 1):
        if fn(q * q, r, f_hz) * 8.0 <= link_bits_per_s:
            best = q * q
        else:
            break
    return best


# ---------------------------------------------------------------------------
# Global projection (paper §5.6, Table 5.7)
# ---------------------------------------------------------------------------

def global_fft_time(n: int, p: int, mu: int = 1, r: int = 4, k: int = 1,
                    f_hz: float = 180e6) -> float:
    """Expected 3D-FFT time as tabulated in Table 5.7.

    Note: the table's entries follow T = (μ+1)·t_clk·N³/(2PRk) — a factor 2
    above Eq. 4.15; we reproduce the table as printed (validated in tests)
    and keep Eq. 4.15 separately in :func:`t_tot_pipelined`.
    """
    return (mu + 1.0) * n**3 / (2.0 * p * r * k) / f_hz


def fits_hbm(n: int, p: int, s: int = S_BYTES,
             limit_bytes: float = HBM_LIMIT_BYTES) -> bool:
    """Table 5.7 feasibility mask: M ≈ 2sN³/P ≤ 8 GiB (O(N²) terms dropped,
    matching the thesis' empty-cell pattern exactly)."""
    return 2.0 * s * n**3 / p <= limit_bytes


def table_5_7(mu: int = 1, r: int = 4, k: int = 1, f_hz: float = 180e6):
    """Reproduce Table 5.7: rows N, cols P; None = exceeds local HBM."""
    rows = {}
    for n in (512, 1024, 2048, 4096, 8192):
        row = {}
        for p in (1, 4, 16, 64, 256, 1024):
            row[p] = global_fft_time(n, p, mu, r, k, f_hz) if fits_hbm(n, p) else None
        rows[n] = row
    return rows


# ---------------------------------------------------------------------------
# Autotuner candidate scoring (paper Eq. 3.3–3.4, §5.5, §5.6)
# ---------------------------------------------------------------------------

#: Relative compute-cost weight of each 1D FFT backend of the port, used
#: only to *rank* autotuner candidates before real timing (the measured
#: sweep decides; these keep obviously-dominated configs out of it).
#: H100 values: each backend's time for the same 1D c2c transform (N=512
#: f64, 512·512 rows, CUDA events, the median of 7) over ``torch.fft.fft``'s
#: (``"jnp"``), from ``chip_smoke.py``'s kernel table on an NVIDIA H100 80GB
#: HBM3 at a 700.00 W power limit: ``fft_radix2`` (``"pallas"``)
#: 1.4970 / 1.4158 = 1.057, ``fft_mxu`` (``"mxu"``, FP64 tensor cores)
#: 1.5099 / 1.4158 = 1.066, the plain radix-2 version (``"ref"``)
#: 62.617 / 1.4158 = 44.2.  The calibration times the backends as the
#: solvers call them (``kops.fft1d``, planar in and out), where ``"jnp"``
#: adds the planar <-> complex copies around the library call and takes
#: twice as long, so its weights for the kernels come out near 0.55.
#: These are the *fallback priors*: :func:`backend_compute_weight` prefers
#: the measured values of an active ``repro_torch.tuning.calibrate`` run.
BACKEND_COMPUTE_WEIGHT = {"jnp": 1.0, "pallas": 1.057, "mxu": 1.066,
                          "ref": 44.2}


#: Which §5.5 fabric each TransposeEngine's traffic is priced on, from the
#: port's own ``core.engine_spec`` (shared with ``core.comm`` and
#: ``core.topology``).
from repro_torch.core.engine_spec import ENGINE_FABRIC, EngineSpec  # noqa: E402,F401


#: Exposed per-message overhead (seconds) each engine pays on its critical
#: path, on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit.  On the
#: card every engine's exchange is driven from the host: each message is a
#: ``ring_send``/``ring_land`` wire copy the host issues.  For the RDMA
#: rings (``pallas_ring``, ``bidi_ring``) the prior is that copy's launch
#: path, 0.036–0.037 ms issued back to back against 0.026 ms on the card
#: (``chip_smoke.py`` phase 4): 36.5e-6 s.  ``switched``, ``torus`` and
#: ``overlap_ring`` carry the zero-payload intercepts that
#: ``python -m repro_torch.tuning.calibrate --mesh 4x1`` measured on the
#: same card, 4 rank processes sharing it (N=128 and 256 folds): 3.41e-3,
#: 4.90e-4 and 1.61e-3 s.  There a fold's time barely depends on its bytes
#: (the ranks' processes take turns on the card), so the intercept is most
#: of it, and a second run of the command read 6.92e-3, 1.44e-3, 0.99e-3.
#: These are the *fallback priors*: :func:`message_overhead_s` prefers the
#: measured values of an active ``repro_torch.tuning.calibrate`` run.
ENGINE_MESSAGE_OVERHEAD_S = {
    "switched": 3.41e-3,
    "torus": 4.90e-4,
    "overlap_ring": 1.61e-3,
    "pallas_ring": 36.5e-6,
    "bidi_ring": 36.5e-6,
}


#: Per-link wire bandwidth (bytes/s) on the card: ``ring_send`` moving two
#: (128, 128, 128) f64 blocks (33.55 MB) in 0.0264 ms (``chip_smoke.py``
#: phase 4, NVIDIA H100 80GB HBM3 at 700.00 W) is 1.27e12 B/s.  This is the
#: *fallback prior*: :func:`link_bytes_per_s` prefers the wire-bandwidth
#: slope measured by an active ``repro_torch.tuning.calibrate`` run (the
#: two-size extrapolation that yields the per-message intercept also yields
#: bytes-per-second).
LINK_BYTES_PER_S = 1.27e12


# ---------------------------------------------------------------------------
# measured calibration overlay (repro_torch.tuning.calibrate)
# ---------------------------------------------------------------------------

_CALIBRATION: dict | None = None
_CALIBRATION_LOADED = False


def set_calibration(doc: dict | None) -> None:
    """Install a calibration document for this process (``None`` pins the
    built-in priors). Overrides the lazily-loaded on-disk calibration until
    :func:`reset_calibration`."""
    global _CALIBRATION, _CALIBRATION_LOADED
    _CALIBRATION = dict(doc) if doc else None
    _CALIBRATION_LOADED = True


def reset_calibration() -> None:
    """Forget any installed calibration; the next query lazily re-loads the
    on-disk document (``$REPRO_TORCH_CALIBRATION`` / the default cache path)."""
    global _CALIBRATION, _CALIBRATION_LOADED
    _CALIBRATION = None
    _CALIBRATION_LOADED = False


def active_calibration() -> dict | None:
    """The calibration document the model currently consults, if any.

    Lazily loads the persisted ``calibration.json`` on first use (only a
    document whose substrate fingerprint matches this process is accepted —
    see ``repro_torch.tuning.calibrate``); :func:`set_calibration`
    short-circuits the load. A missing/invalid/foreign file means priors.
    """
    global _CALIBRATION, _CALIBRATION_LOADED
    if not _CALIBRATION_LOADED:
        _CALIBRATION_LOADED = True
        from repro_torch.tuning.calibrate import load_active_calibration
        _CALIBRATION = load_active_calibration()
    return _CALIBRATION


def message_overhead_s(engine: str) -> float:
    """Exposed per-message cost of ``engine`` on this substrate: the
    measured value of the active calibration when one exists, else the
    ``ENGINE_MESSAGE_OVERHEAD_S`` prior."""
    if engine not in ENGINE_MESSAGE_OVERHEAD_S:
        raise ValueError(f"unknown comm engine {engine!r}; "
                         f"have {sorted(ENGINE_MESSAGE_OVERHEAD_S)}")
    cal = active_calibration() or {}
    got = (cal.get("engine_message_overhead_s") or {}).get(engine)
    if isinstance(got, (int, float)) and got > 0:
        return float(got)
    return ENGINE_MESSAGE_OVERHEAD_S[engine]


def backend_compute_weight(backend: str) -> float:
    """Relative compute cost of ``backend``: measured (active calibration)
    when available, else the ``BACKEND_COMPUTE_WEIGHT`` prior (1.0 for
    unknown backends, matching the old ``.get`` default)."""
    cal = active_calibration() or {}
    got = (cal.get("backend_compute_weight") or {}).get(backend)
    if isinstance(got, (int, float)) and got > 0:
        return float(got)
    return BACKEND_COMPUTE_WEIGHT.get(backend, 1.0)


def link_bytes_per_s() -> float:
    """Effective per-link wire bandwidth on this substrate: the slope the
    active calibration measured (``repro_torch.tuning.calibrate`` extrapolates
    two fold sizes; the slope is bytes moved per wall second), else the
    ``LINK_BYTES_PER_S`` prior."""
    cal = active_calibration() or {}
    got = cal.get("link_bytes_per_s")
    if isinstance(got, (int, float)) and got > 0:
        return float(got)
    return LINK_BYTES_PER_S


def _resolve_link_rate(value: float | None) -> float:
    """An explicit caller override wins; ``None`` asks the calibration."""
    return float(value) if value is not None else link_bytes_per_s()


def bidi_round_ratio(q: int) -> float:
    """Wire-time ratio of the bidirectional ring vs the unidirectional one
    over a ``q``-rank dimension: ``ceil((q−1)/2) / (q−1)`` exchange rounds
    (both directions carry blocks concurrently; 1.0 at q ≤ 2 where both
    directions name the same neighbor)."""
    if q <= 2:
        return 1.0
    return (q // 2) / (q - 1)


def fold_messages(q, fabric: str, engine: str = "") -> int:
    """Exposed message dispatches one rank pays for one fold over a
    ``q``-rank dimension: one tiled all-to-all on the switched fabric, q−1
    ring rounds on the torus (Fig. 5.9/5.10) — except the bidirectional
    ring, whose two per-round sends are posted concurrently on opposite
    links, leaving ``ceil((q−1)/2)`` round dispatches on the critical path.
    Zero when the fold never communicates.

    ``q`` may be a tuple of per-mesh-axis sizes (a grid dimension spanning
    several mesh axes, e.g. ``(Pu₀, Pu₁)``): the ring engines stage one
    ring per axis, so the torus fabrics pay Σᵢ ``fold_messages(qᵢ)`` round
    dispatches, while the switched fabric still dispatches one all-to-all
    over the whole product group."""
    if isinstance(q, (tuple, list)):
        sizes = [int(x) for x in q if int(x) > 1]
        if not sizes:
            return 0
        if fabric == "switched":
            return 1
        return sum(fold_messages(x, fabric, engine) for x in sizes)
    if q <= 1:
        return 0
    if fabric == "switched":
        return 1
    if engine == "bidi_ring":
        return q // 2
    return q - 1


def _dim_sizes(q: int, q_axes) -> tuple[int, ...]:
    """Normalize a grid dimension to its per-mesh-axis factorization.

    ``q_axes=None`` means the flat single-axis view ``(q,)``; an explicit
    factorization must multiply out to ``q``.
    """
    if q_axes is None:
        return (max(int(q), 1),)
    sizes = tuple(int(x) for x in q_axes)
    if math.prod(sizes) != max(int(q), 1):
        raise ValueError(f"per-axis sizes {sizes} do not factor P={q}")
    return sizes


def _fold_wire_seconds(v_prime: float, sizes: tuple[int, ...], *,
                       fabric: str, link_bytes_per_s: float,
                       bidi: bool = False) -> float:
    """Wire seconds of one fold moving V′ bytes (Eq. 3.4) over a — possibly
    multi-mesh-axis — grid dimension: the Eq. 5.5/5.6 fabric penalty per
    axis, one all-to-all over the product group on the switched fabric,
    one staged ring per axis on the torus fabrics."""
    def axis_seconds(q: int) -> float:
        t = v_prime * (q - 1) / q / link_bytes_per_s
        if fabric == "torus":
            t *= max(1.0, q / 2.0)  # Eq. 5.6 vs 5.5 required-bandwidth ratio
        if bidi:
            t *= bidi_round_ratio(q)  # both directions stream concurrently
        return t

    sizes = tuple(q for q in sizes if q > 1)
    if not sizes:
        return 0.0
    if fabric == "switched":
        # one all-to-all over the product group regardless of staging
        return axis_seconds(math.prod(sizes))
    return sum(axis_seconds(q) for q in sizes)


def estimate_fold_seconds(n, pu: int, pv: int, dim_sizes, *,
                          comm_engine: str = "switched", mu: int = 1,
                          link_bytes_per_s: float | None = None,
                          s: int = S_BYTES) -> float:
    """Wire seconds of one fold over one grid dimension (the per-phase
    slice of :func:`estimate_plan_seconds`'s network term): V′ of Eq. 3.4
    across ``dim_sizes`` — the per-mesh-axis factorization of the folding
    dimension (``PencilGrid.u_sizes``/``v_sizes``) — on ``comm_engine``'s
    fabric with the Eq. 5.5/5.6 penalty. Used by the observability layer
    to annotate each fold span with its own model prediction."""
    if comm_engine not in ENGINE_FABRIC:
        raise ValueError(f"unknown comm engine {comm_engine!r}; "
                         f"have {sorted(ENGINE_FABRIC)}")
    nx, ny, nz = (n, n, n) if isinstance(n, int) else tuple(n)
    p = max(pu, 1) * max(pv, 1)
    v_prime = max(mu, 1) * s * (nx * ny * nz + 2 * ny * nz) / p  # Eq. 3.4
    return _fold_wire_seconds(
        v_prime, tuple(int(x) for x in dim_sizes),
        fabric=ENGINE_FABRIC[comm_engine],
        link_bytes_per_s=_resolve_link_rate(link_bytes_per_s),
        bidi=comm_engine == "bidi_ring")


def _comp_net_seconds(n, pu: int, pv: int, *, fabric: str, backend: str,
                      schedule: str, mu: int, r2c_packed: bool, r: int,
                      f_hz: float, link_bytes_per_s: float,
                      s: int, bidi: bool = False,
                      pu_axes=None, pv_axes=None) -> tuple[float, float]:
    """(T_comp, T_net) of one transform: Eq. 4.14/4.15 compute and the
    per-fold V′ traffic of Eq. 3.4 with the Eq. 5.5/5.6 fabric penalty.
    ``bidi`` scales each fold's wire time by the bidirectional ring's
    round ratio (both torus directions carry blocks concurrently).
    ``pu_axes``/``pv_axes`` give the per-mesh-axis factorization of each
    grid dimension: on the torus fabrics a fold over several axes runs one
    staged ring per axis, so its wire time is Σᵢ over single-axis rings
    (each with that axis' own q/2 multi-hop penalty) instead of one flat
    ring over the product — the multi-axis schedule is strictly cheaper.
    Shared by :func:`estimate_plan_seconds` and :func:`optimal_chunks`."""
    nx, ny, nz = (n, n, n) if isinstance(n, int) else tuple(n)
    p = max(pu, 1) * max(pv, 1)
    mu = max(mu, 1)
    vol = nx * ny * nz
    if schedule == "pipelined":
        # Eq. 4.15 with k=1: the k in the paper is *hardware engine
        # replication* (doubled X engines); our software slab count adds no
        # compute throughput — chunks only enter via the overlap/fill terms.
        t_comp = (mu + 1.0) * vol / (4.0 * p * r) / f_hz
    else:
        t_comp = 2.0 * mu * vol / (2.0 * p * r) / f_hz          # Eq. 4.14
    t_comp *= backend_compute_weight(backend)
    if r2c_packed:
        t_comp *= 5.0 / 6.0  # X phase runs an N/2-point engine (1 of 3 phases)

    v_prime = mu * s * (vol + 2 * ny * nz) / p                  # Eq. 3.4

    def fold_seconds(sizes: tuple[int, ...]) -> float:
        return _fold_wire_seconds(v_prime, sizes, fabric=fabric,
                                  link_bytes_per_s=link_bytes_per_s,
                                  bidi=bidi)

    return t_comp, (fold_seconds(_dim_sizes(pu, pu_axes))
                    + fold_seconds(_dim_sizes(pv, pv_axes)))


def estimate_plan_seconds(n, pu: int, pv: int, *, backend: str = "jnp",
                          schedule: str = "sequential", chunks: int = 1,
                          net: str = "switched", comm_engine: str = "",
                          mu: int = 1,
                          r2c_packed: bool = False, r: int = 4,
                          f_hz: float = 180e6,
                          link_bytes_per_s: float | None = None,
                          s: int = S_BYTES, spec: EngineSpec | None = None,
                          pu_axes=None, pv_axes=None) -> float:
    """Analytic time estimate for one ``FFT3DPlan`` configuration.

    This is the paper's model wearing an autotuner hat: compute follows the
    task-organization forms of Ch. 4 (Eq. 4.14 sequential / Eq. 4.15
    pipelined, as tabulated in §5.6), the per-fold traffic is V′ of Eq. 3.4,
    and the torus penalty is the Eq. 5.5/5.6 required-bandwidth ratio
    (B_torus/B_switched = √P/2 → ×q/2 time per fold over a q-rank dimension).

    ``comm_engine`` makes the estimate overlap- and overhead-aware: serial
    engines (``switched``/``torus``) pay compute + communication
    back-to-back per phase (only the ``pipelined`` schedule's slab overlap
    helps them) plus one exposed message dispatch per slab exchange; the
    overlapped rings interleave butterflies with every ring round, so the
    longer of the two streams dominates — ``max(T_comp, T_net)`` plus a
    pipeline-fill term that shrinks with the slab count and the steady-state
    ring-round dispatches. ``pallas_ring`` is the same timeline with its
    sends posted by the kernel itself: half the exposed fill (double
    buffering) and the NIC-doorbell message cost of
    :func:`message_overhead_s`. ``bidi_ring`` additionally drives both
    torus directions per round (Fig. 5.9), scaling each fold's wire time
    and round dispatches by ``ceil((q−1)/2)/(q−1)``. Message overheads and
    backend weights come from the active measured calibration when one
    exists (``repro_torch.tuning.calibrate``), else the built-in priors.
    ``spec`` supplies the engine configuration as one
    :class:`~repro_torch.core.engine_spec.EngineSpec`, overriding the individual
    ``backend/schedule/chunks/comm_engine/r2c_packed`` arguments.
    ``pu_axes``/``pv_axes`` give the per-mesh-axis factorization of the
    grid dimensions (``PencilGrid.u_sizes``/``v_sizes``): the ring engines
    then pay per-axis rounds — Σᵢ(qᵢ−1) instead of P−1 — with each staged
    ring priced at its own axis' multi-hop penalty.
    ``link_bytes_per_s=None`` (the default) uses the measured wire
    bandwidth of the active calibration via :func:`link_bytes_per_s`, else
    the prior. Compute is in nominal-FPGA seconds (Eq. 4.14/4.15), the
    wire and messages in the substrate's; the
    autotuner only uses the *ordering* to prune the sweep.
    """
    link_bytes_per_s = _resolve_link_rate(link_bytes_per_s)
    if spec is not None:
        backend, schedule = spec.backend, spec.schedule
        chunks, comm_engine = spec.chunks, spec.engine
        r2c_packed = spec.r2c_packed
    engine = comm_engine or net
    if engine not in ENGINE_FABRIC:
        raise ValueError(f"unknown comm engine {engine!r}; "
                         f"have {sorted(ENGINE_FABRIC)}")
    fabric = ENGINE_FABRIC[engine]
    k = max(chunks, 1)
    t_comp, t_net = _comp_net_seconds(
        n, pu, pv, fabric=fabric, backend=backend, schedule=schedule, mu=mu,
        r2c_packed=r2c_packed, r=r, f_hz=f_hz,
        link_bytes_per_s=link_bytes_per_s, s=s, bidi=engine == "bidi_ring",
        pu_axes=pu_axes, pv_axes=pv_axes)
    t_msg = message_overhead_s(engine)
    msgs = (fold_messages(_dim_sizes(pu, pu_axes), fabric, engine)
            + fold_messages(_dim_sizes(pv, pv_axes), fabric, engine))
    if engine in ("overlap_ring", "pallas_ring", "bidi_ring") \
            and (pu > 1 or pv > 1):
        # block-granular overlap: every ring round's latency hides under
        # another block's butterflies (Fig. 4.3), so the longer stream
        # dominates and only a pipeline-fill fraction of the shorter one
        # remains exposed. The engine cuts each fold into one slab per ring
        # rank (or ``chunks``), so the fill shrinks with the total slab
        # count — and the estimate can never exceed the serial sum, since
        # overlapping identical work cannot be slower. Message dispatches
        # pipeline with the compute too; only the steady-state round count
        # stays on the critical path. The RDMA rings' explicit
        # double buffering halves the exposed fill. On a 1×1 grid nothing
        # communicates and the engine degenerates to the serial forms below.
        slabs = max(max(pu, 1) + max(pv, 1), k, 2)
        fill = min(t_comp, t_net) / slabs
        if engine in ("pallas_ring", "bidi_ring"):
            fill /= 2.0
        return max(t_comp, t_net) + fill + msgs * t_msg
    overhead = k * msgs * t_msg  # one exposed dispatch per slab exchange
    if schedule == "pipelined":
        # slab i+1's butterflies run under slab i's fold (Fig. 4.3): the
        # longer of the two streams dominates, plus a 1/k pipeline-fill term.
        return max(t_comp, t_net) + (t_comp + t_net) / k + overhead
    return t_comp + t_net + overhead


def estimate_roundtrip_seconds(n, pu: int, pv: int, *,
                               fused: bool | None = None,
                               kernel_weight: float = 1.0,
                               backend: str = "jnp",
                               schedule: str = "sequential", chunks: int = 1,
                               net: str = "switched", comm_engine: str = "",
                               mu: int = 1, r2c_packed: bool = False,
                               r: int = 4, f_hz: float = 180e6,
                               link_bytes_per_s: float | None = None,
                               s: int = S_BYTES,
                               spec: EngineSpec | None = None,
                               pu_axes=None, pv_axes=None) -> float:
    """Analytic time of one diagonal spectral roundtrip — forward 3D FFT,
    pointwise k-space multiply, inverse 3D FFT — for one plan config.

    Composed (``fused=False``) prices the three phases back to back: two
    full transforms (:func:`estimate_plan_seconds`) plus one exposed
    kernel sweep over the local spectrum, ``kernel_weight`` engine passes
    at R points per cycle (1.0 for a plain complex multiply; heavier
    per-point operators scale it up). The fused executor
    (``fused=True``, or ``spec.fused_roundtrip``) threads kx-slabs through
    Y↔Z fold → Z-FFT → kernel → inverse Z-FFT → Y↔Z unfold with no
    full-volume barrier, so slab k's kernel sweep runs under slab k+1's
    fold and slab k−1's unfold — the kernel time hides up to the
    roundtrip's Y↔Z wire budget (one fold plus one unfold):

        fused = composed − min(T_kernel, 2·T_yz_wire)

    With no Y↔Z communication (``pv == 1``) nothing hides and
    fused == composed; the estimate therefore never predicts the fused
    schedule above the composed one. All other knobs match
    :func:`estimate_plan_seconds`.
    """
    if spec is not None:
        if fused is None:
            fused = spec.fused_roundtrip
        backend, schedule = spec.backend, spec.schedule
        chunks, comm_engine = spec.chunks, spec.engine
        r2c_packed = spec.r2c_packed
    engine = comm_engine or net
    if engine not in ENGINE_FABRIC:
        raise ValueError(f"unknown comm engine {engine!r}; "
                         f"have {sorted(ENGINE_FABRIC)}")
    link_bytes_per_s = _resolve_link_rate(link_bytes_per_s)
    one = estimate_plan_seconds(
        n, pu, pv, backend=backend, schedule=schedule, chunks=chunks,
        comm_engine=engine, mu=mu, r2c_packed=r2c_packed, r=r, f_hz=f_hz,
        link_bytes_per_s=link_bytes_per_s, s=s,
        pu_axes=pu_axes, pv_axes=pv_axes)
    nx, ny, nz = (n, n, n) if isinstance(n, int) else tuple(n)
    p = max(pu, 1) * max(pv, 1)
    mu = max(mu, 1)
    t_kernel = (max(kernel_weight, 0.0) * backend_compute_weight(backend)
                * mu * nx * ny * nz / (2.0 * p * r) / f_hz)
    composed = 2.0 * one + t_kernel
    if not fused:
        return composed
    fabric = ENGINE_FABRIC[engine]
    v_prime = mu * s * (nx * ny * nz + 2 * ny * nz) / p         # Eq. 3.4
    t_yz = 2.0 * _fold_wire_seconds(
        v_prime, _dim_sizes(pv, pv_axes), fabric=fabric,
        link_bytes_per_s=link_bytes_per_s, bidi=engine == "bidi_ring")
    return composed - min(t_kernel, t_yz)


# ---------------------------------------------------------------------------
# Engine-aware chunk-size model (paper Fig. 4.3's slab-count knob)
# ---------------------------------------------------------------------------

MAX_MODEL_CHUNKS = 32          # finest slab granularity the model proposes
_FALLBACK_CHUNKS = (2, 4, 8)   # engine-blind legacy choices (no-comm grids)


def optimal_chunks(n, pu: int, pv: int, *, comm_engine: str = "",
                   backend: str = "jnp", schedule: str = "pipelined",
                   mu: int = 1, r2c_packed: bool = False, r: int = 4,
                   f_hz: float = 180e6,
                   link_bytes_per_s: float | None = None,
                   s: int = S_BYTES, spec: EngineSpec | None = None,
                   pu_axes=None, pv_axes=None) -> int:
    """Model-optimal slab count for one engine on one problem.

    Chunking trades the pipeline-fill exposure (the ``(T_comp+T_net)/k``
    term of the Fig. 4.3 timeline — one slab's fold latency stays
    unhidden) against per-message overhead (each extra slab re-dispatches
    the fold's messages: one all-to-all on the switched fabric, q−1 ring
    rounds on the torus). Minimizing

        T(k) ≈ (T_comp + T_net)/k + k · m · t_msg

    gives ``k* = sqrt((T_comp + T_net) / (m · t_msg))``, snapped to the
    nearest power of two in ``[1, MAX_MODEL_CHUNKS]``. The model is
    engine-aware through both the per-message cost ``t_msg``
    (:func:`message_overhead_s` — measured by ``repro_torch.tuning.calibrate``
    when a calibration is active, else the prior) and
    the per-slab message count ``m`` (``fold_messages`` on the engine's
    fabric — halved round dispatches for ``bidi_ring``, summed per mesh
    axis when ``pu_axes``/``pv_axes`` factor a grid dimension over several).
    ``spec`` supplies ``comm_engine``/``backend``/``r2c_packed`` in one
    object (its ``schedule`` is ignored — the answer is by definition for
    the pipelined schedule). Returns 1 when no fold communicates
    (nothing to overlap).
    """
    link_bytes_per_s = _resolve_link_rate(link_bytes_per_s)
    if spec is not None:
        # schedule stays "pipelined": the question this model answers is what
        # slab count the pipelined schedule should run at for spec's engine.
        comm_engine, backend = spec.engine, spec.backend
        r2c_packed = spec.r2c_packed
    if comm_engine not in ENGINE_FABRIC:
        raise ValueError(f"unknown comm engine {comm_engine!r}; "
                         f"have {sorted(ENGINE_FABRIC)}")
    fabric = ENGINE_FABRIC[comm_engine]
    msgs = (fold_messages(_dim_sizes(pu, pu_axes), fabric, comm_engine)
            + fold_messages(_dim_sizes(pv, pv_axes), fabric, comm_engine))
    t_msg = message_overhead_s(comm_engine)
    if msgs == 0 or t_msg <= 0:
        return 1
    t_comp, t_net = _comp_net_seconds(
        n, pu, pv, fabric=fabric, backend=backend, schedule=schedule, mu=mu,
        r2c_packed=r2c_packed, r=r, f_hz=f_hz,
        link_bytes_per_s=link_bytes_per_s, s=s, bidi=comm_engine == "bidi_ring",
        pu_axes=pu_axes, pv_axes=pv_axes)
    k_star = math.sqrt((t_comp + t_net) / (msgs * t_msg))
    if k_star <= 1.0:
        return 1
    snapped = 2 ** round(math.log2(k_star))
    return int(min(max(snapped, 1), MAX_MODEL_CHUNKS))


def chunk_candidates(n, pu: int, pv: int, comm_engine: str,
                     **kwargs) -> tuple[int, ...]:
    """Pipelined slab counts worth timing for this engine and problem:
    the model optimum and its power-of-two neighbors (the measured sweep
    decides — the model only keeps obviously-dominated counts out of it).
    Falls back to the engine-blind legacy choices when no fold
    communicates, where the model has no signal to prune on."""
    opt = optimal_chunks(n, pu, pv, comm_engine=comm_engine, **kwargs)
    if opt <= 1 and fold_messages(max(pu, 1), ENGINE_FABRIC[comm_engine]) \
            + fold_messages(max(pv, 1), ENGINE_FABRIC[comm_engine]) == 0:
        return _FALLBACK_CHUNKS
    cands = {c for c in (opt // 2, opt, 2 * opt)
             if 2 <= c <= MAX_MODEL_CHUNKS}
    return tuple(sorted(cands)) or (2,)


# ---------------------------------------------------------------------------
# Required-RAM trend (paper Fig. 1.1)
# ---------------------------------------------------------------------------

def required_ram_per_node(n: int, p: int, s: int = S_BYTES) -> float:
    """Fig. 1.1: one complex double field = 2s·N³/P bytes per node."""
    return 2.0 * s * n**3 / p
