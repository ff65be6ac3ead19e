"""The port's perf model and topology against the reference's.

Every public function of ``repro_torch.core.perfmodel`` and
``repro_torch.core.topology`` (and the two private formulas the estimates
share, ``_fold_wire_seconds`` and ``_comp_net_seconds``) is run beside
``repro.core.perfmodel`` / ``repro.core.topology`` on one grid of inputs:
n from 8 to 8192 (cubic and not), Pu and Pv from 1 to 64, every engine and
backend, both schedules, staged per-mesh-axis factorizations.  Both
packages run under the same installed calibration (every engine, backend
and the wire rate measured), so the substrate priors play no part and the
results are **equal**: the same float operations.  The port's own priors
are the H100 values its comments derive.
"""

import itertools
import math

import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.core import engine_spec as jes
from repro.core import perfmodel as jpm
from repro.core import topology as jtopo
from repro_torch.configs import fft_configs
from repro_torch.core import engine_spec as es
from repro_torch.core import perfmodel as pm
from repro_torch.core import topology as topo

ENGINES = tuple(pm.ENGINE_FABRIC)
BACKENDS = ("jnp", "ref", "pallas", "mxu")
NS = (8, 64, 512, 8192, (8, 16, 32))
GRIDS = ((1, 1), (2, 1), (1, 4), (2, 2), (4, 2), (8, 8), (64, 1), (1, 64),
         (64, 64))
# (pu, pv, pu_axes, pv_axes): per-mesh-axis factorizations of a grid
STAGED = ((4, 2, (2, 2), None), (8, 2, (2, 4), (2,)), (4, 4, (4,), (2, 2)),
          (16, 1, (2, 2, 4), None), (2, 8, None, (2, 2, 2)))
CALIBRATION = {
    "engine_message_overhead_s": {"switched": 3.1e-5, "torus": 4.7e-5,
                                  "overlap_ring": 2.9e-5,
                                  "pallas_ring": 1.3e-5, "bidi_ring": 1.1e-5},
    "backend_compute_weight": {"jnp": 1.0, "ref": 37.5, "pallas": 1.21,
                               "mxu": 0.93},
    "link_bytes_per_s": 3.3e11,
}


@pytest.fixture(autouse=True)
def _same_calibration():
    pm.set_calibration(CALIBRATION)
    jpm.set_calibration(CALIBRATION)
    yield
    pm.set_calibration(None)
    jpm.set_calibration(None)


def _eq(a, b):
    # equal, NaN included; dicts/tuples/lists element by element
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_eq(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b and type(a) is type(b)


def _both(fn_name, *args, **kw):
    got = getattr(pm, fn_name)(*args, **kw)
    want = getattr(jpm, fn_name)(*args, **kw)
    assert _eq(got, want), (fn_name, args, kw, got, want)
    return got


def _grids():
    for pu, pv in GRIDS:
        yield pu, pv, None, None
    yield from STAGED


def _spec_pair(**kw):
    return es.EngineSpec(**kw), jes.EngineSpec(**kw)


# ---------------------------------------------------------------------------
# the paper's closed forms (no substrate constant)
# ---------------------------------------------------------------------------

ENGINE_FORMS = {
    "l_butterfly": lambda: [((l_op,), {}) for l_op in (1, 9, 14)],
    "l_fft_cycles": lambda: [((n, l_op, r), {}) for n in (8, 512, 8192)
                             for l_op in (9, 14) for r in (1, 2, 4)],
    "engine_latency_cycles": lambda: [((n, 9, r), {}) for n in (16, 4096)
                                      for r in (1, 2, 4)],
    "t_fft_seconds": lambda: [((n, r, 9, f), {}) for n in (8, 8192)
                              for r in (1, 4) for f in (180e6, 380e6)],
    "b_fft_bytes_per_s": lambda: [((r, f), {"s": s}) for r in (1, 4)
                                  for f in (180e6, 250e6) for s in (4, 8)],
    "engine_gflops": lambda: [((n, r, f), {}) for n in (8, 8192)
                              for r in (1, 4) for f in (180e6, 380e6)],
    "t_tot_sequential": lambda: [((n, p, r, q, 180e6), {"mu": mu, "exact": ex,
                                                        "l_dma": 3, "l_comm": 5})
                                 for n in (64, 512) for p in (1, 16) for r in (1, 4)
                                 for q in (1, 4) for mu in (1, 3)
                                 for ex in (False, True)],
    "t_tot_pipelined": lambda: [((n, p, r, k, 180e6), {"mu": mu})
                                for n in (64, 8192) for p in (1, 64) for r in (1, 4)
                                for k in (1, 2) for mu in (1, 3)],
    "t_tot_parallel": lambda: [((n, p, r, 180e6), {"mu": mu}) for n in (64, 8192)
                               for p in (1, 64) for r in (1, 4) for mu in (1, 3)],
    "table_4_1": lambda: [((mu,), {}) for mu in (1, 2, 3)],
    "table_4_2": lambda: [((mu,), {}) for mu in (1, 2, 3)],
    "m_tot_sequential_bytes": lambda: [((n, p), {}) for n in (8, 8192)
                                       for p in (1, 4, 1024)],
    "m_tot_pipelined_bytes": lambda: [((n, p, pu), {}) for n in (8, 8192)
                                      for p, pu in ((1, 1), (16, 4), (1024, 32))],
    "b_net_switched": lambda: [((p, r, f), {}) for p in (1, 4, 64, 1024)
                               for r in (1, 4) for f in (180e6, 380e6)],
    "b_net_torus": lambda: [((p, r, f), {}) for p in (1, 4, 64, 1024)
                            for r in (1, 4) for f in (180e6, 380e6)],
    "max_scalable_p": lambda: [((r, f, link), {"topology": t, "sq_max": 32})
                               for r in (1, 4) for f in (180e6, 380e6)
                               for link in (100e9, 400e9)
                               for t in ("switched", "torus")],
    "global_fft_time": lambda: [((n, p), {"mu": mu, "r": r, "k": k})
                                for n in (512, 8192) for p in (1, 1024)
                                for mu in (1, 3) for r in (1, 4) for k in (1, 2)],
    "fits_hbm": lambda: [((n, p), {}) for n in (512, 2048, 8192)
                         for p in (1, 4, 64, 1024)],
    "table_5_7": lambda: [((), {"mu": mu, "r": r}) for mu in (1, 3) for r in (1, 4)],
    "required_ram_per_node": lambda: [((n, p), {}) for n in (512, 8192)
                                      for p in (1, 64)],
    "bidi_round_ratio": lambda: [((q,), {}) for q in range(1, 65)],
}


@pytest.mark.parametrize("fn_name", sorted(ENGINE_FORMS))
def test_closed_forms_equal_the_reference(fn_name):
    for args, kw in ENGINE_FORMS[fn_name]():
        _both(fn_name, *args, **kw)


def test_engine_point_and_constants_equal_the_reference():
    for n, r, l_op, f in itertools.product((16, 8192), (1, 4), (9, 14),
                                           (180.0, 380.0)):
        a, b = pm.EnginePoint(n, r, l_op, f), jpm.EnginePoint(n, r, l_op, f)
        for attr in ("latency_cycles", "l_fft_us", "t_fft_us", "b_fft_gib_s",
                     "gflops"):
            assert getattr(a, attr) == getattr(b, attr), attr
    # the paper's FPGA model constants stay the paper's
    for name in ("S_BYTES", "GIB", "HBM_LIMIT_BYTES", "MAX_MODEL_CHUNKS",
                 "_FALLBACK_CHUNKS"):
        assert getattr(pm, name) == getattr(jpm, name), name
    assert pm.ENGINE_FABRIC == jpm.ENGINE_FABRIC
    # the paper's problem table is the reference's
    from repro.configs import fft_configs as jcfg
    assert {k: vars(v) for k, v in fft_configs.PAPER_PROBLEMS.items()} == \
        {k: vars(v) for k, v in jcfg.PAPER_PROBLEMS.items()}
    assert fft_configs.PAPER_PROBLEMS["fft512_p1"].n == 512


# ---------------------------------------------------------------------------
# the substrate-aware estimates, under one calibration
# ---------------------------------------------------------------------------

def test_calibrated_lookups_equal_the_reference():
    for engine in ENGINES:
        assert _both("message_overhead_s", engine) == \
            CALIBRATION["engine_message_overhead_s"][engine]
    for backend in BACKENDS + ("unknown",):
        _both("backend_compute_weight", backend)
    assert _both("link_bytes_per_s") == CALIBRATION["link_bytes_per_s"]
    for q in (1, 2, 3, 7, (1,), (2, 2), (2, 4, 1), [4, 4]):
        for fabric in ("switched", "torus"):
            for engine in ("",) + ENGINES:
                _both("fold_messages", q, fabric, engine)
    with pytest.raises(ValueError):
        pm.message_overhead_s("carrier_pigeon")
    with pytest.raises(ValueError, match="do not factor"):
        pm._dim_sizes(4, (2, 3))


def test_fold_wire_and_compute_terms_equal_the_reference():
    for v_prime, sizes, fabric, bidi in itertools.product(
            (1e3, 2.5e9), ((1,), (2,), (8,), (2, 2), (2, 4, 8)),
            ("switched", "torus"), (False, True)):
        _both("_fold_wire_seconds", v_prime, sizes, fabric=fabric,
              link_bytes_per_s=3.3e11, bidi=bidi)
    for n, (pu, pv, ua, va), backend, schedule in itertools.product(
            NS, _grids(), BACKENDS, ("sequential", "pipelined")):
        for fabric, mu, packed in itertools.product(("switched", "torus"),
                                                    (1, 3), (False, True)):
            _both("_comp_net_seconds", n, pu, pv, fabric=fabric, backend=backend,
                  schedule=schedule, mu=mu, r2c_packed=packed, r=4, f_hz=180e6,
                  link_bytes_per_s=3.3e11, s=8, bidi=fabric == "torus",
                  pu_axes=ua, pv_axes=va)


def test_estimate_fold_seconds_equals_the_reference():
    for n, (pu, pv, ua, va), engine, mu in itertools.product(
            NS, _grids(), ENGINES, (1, 3)):
        for sizes in {ua or (pu,), va or (pv,)}:
            _both("estimate_fold_seconds", n, pu, pv, sizes, comm_engine=engine,
                  mu=mu)
    with pytest.raises(ValueError):
        pm.estimate_fold_seconds(8, 2, 1, (2,), comm_engine="carrier_pigeon")


@pytest.mark.parametrize("engine", ENGINES)
def test_estimate_plan_seconds_equals_the_reference(engine):
    for n, (pu, pv, ua, va), backend in itertools.product(NS, _grids(), BACKENDS):
        for schedule, chunks in (("sequential", 1), ("pipelined", 2),
                                 ("pipelined", 8)):
            for mu, packed in itertools.product((1, 3), (False, True)):
                _both("estimate_plan_seconds", n, pu, pv, backend=backend,
                      schedule=schedule, chunks=chunks, comm_engine=engine,
                      mu=mu, r2c_packed=packed, pu_axes=ua, pv_axes=va)
                mine, ref = _spec_pair(engine=engine, backend=backend,
                                       schedule=schedule, chunks=chunks,
                                       r2c_packed=packed)
                assert pm.estimate_plan_seconds(
                    n, pu, pv, spec=mine, mu=mu, pu_axes=ua, pv_axes=va) == \
                    jpm.estimate_plan_seconds(n, pu, pv, spec=ref, mu=mu,
                                              pu_axes=ua, pv_axes=va)
    # an explicit wire rate overrides the calibrated one, in both
    _both("estimate_plan_seconds", 512, 4, 2, comm_engine=engine,
          link_bytes_per_s=25e9)
    # the legacy fabric knob names the engine
    _both("estimate_plan_seconds", 64, 2, 2, net="torus")


@pytest.mark.parametrize("engine", ENGINES)
def test_estimate_roundtrip_seconds_equals_the_reference(engine):
    for n, (pu, pv, ua, va), backend in itertools.product(NS, _grids(), BACKENDS):
        for fused, kw, chunks in itertools.product((None, False, True),
                                                   (0.0, 1.0, 4.5), (1, 4)):
            schedule = "pipelined" if chunks > 1 else "sequential"
            _both("estimate_roundtrip_seconds", n, pu, pv, fused=fused,
                  kernel_weight=kw, backend=backend, schedule=schedule,
                  chunks=chunks, comm_engine=engine, pu_axes=ua, pv_axes=va)
        for fused_spec in (False, True):
            mine, ref = _spec_pair(engine=engine, backend=backend,
                                   fused_roundtrip=fused_spec)
            assert pm.estimate_roundtrip_seconds(
                n, pu, pv, spec=mine, pu_axes=ua, pv_axes=va) == \
                jpm.estimate_roundtrip_seconds(n, pu, pv, spec=ref,
                                               pu_axes=ua, pv_axes=va)


@pytest.mark.parametrize("engine", ENGINES)
def test_chunk_model_equals_the_reference(engine):
    for n, (pu, pv, ua, va), backend in itertools.product(NS, _grids(), BACKENDS):
        for mu, packed in itertools.product((1, 3), (False, True)):
            kw = dict(backend=backend, mu=mu, r2c_packed=packed,
                      pu_axes=ua, pv_axes=va)
            _both("optimal_chunks", n, pu, pv, comm_engine=engine, **kw)
            _both("chunk_candidates", n, pu, pv, engine, **kw)
        mine, ref = _spec_pair(engine=engine, backend=backend)
        assert pm.optimal_chunks(n, pu, pv, spec=mine, pu_axes=ua, pv_axes=va) == \
            jpm.optimal_chunks(n, pu, pv, spec=ref, pu_axes=ua, pv_axes=va)


# ---------------------------------------------------------------------------
# topology over the port's model
# ---------------------------------------------------------------------------

def test_topology_equals_the_reference():
    for topology, p, r, f in itertools.product(("switched", "torus"),
                                               (1, 4, 64, 1024), (1, 4),
                                               (180.0, 380.0)):
        a, b = topo.NetworkPlan(topology, p, r, f), jtopo.NetworkPlan(topology, p, r, f)
        for attr in ("message_overhead_s", "nics_per_node", "required_bw_bytes_s",
                     "required_bw_gbit_s", "n_switches"):
            assert getattr(a, attr) == getattr(b, attr), (topology, p, attr)
        assert a.fits(200.0) == b.fits(200.0)
    for engine, n, (p, pu, pv, ua) in itertools.product(
            ENGINES, (None, 64, 512, (64, 128, 256)),
            ((16, 0, 0, None), (8, 0, 0, None), (8, 4, 2, (2, 2)), (64, 8, 8, None))):
        mine, ref = _spec_pair(engine=engine)
        a = topo.NetworkPlan.for_spec(mine, p, 4, 180.0, n=n, pu=pu, pv=pv,
                                      pu_axes=ua)
        b = jtopo.NetworkPlan.for_spec(ref, p, 4, 180.0, n=n, pu=pu, pv=pv,
                                       pu_axes=ua)
        assert dataclasses_equal(a, b) and a.message_overhead_s == b.message_overhead_s
    with pytest.raises(ValueError, match="pu\\*pv"):
        topo.NetworkPlan.for_spec(es.EngineSpec(), 8, 4, 180.0, pu=3, pv=2)
    assert topo.bandwidth_curves("switched") == jtopo.bandwidth_curves("switched")
    assert topo.bandwidth_curves("torus", r_values=(2,)) == \
        jtopo.bandwidth_curves("torus", r_values=(2,))
    for link in (100.0, 200.0, 400.0):
        assert topo.scalability_summary(link) == jtopo.scalability_summary(link)
    assert topo.ENGINE_FABRIC == jtopo.ENGINE_FABRIC
    assert (topo.LINK_CAPS_GBPS, topo.FREQS_MHZ) == (jtopo.LINK_CAPS_GBPS,
                                                     jtopo.FREQS_MHZ)


def dataclasses_equal(a, b) -> bool:
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------------------
# the port's priors are the H100's
# ---------------------------------------------------------------------------

def test_uncalibrated_priors_are_the_h100_values():
    # chip_smoke.py's kernel table, NVIDIA H100 80GB HBM3 at 700.00 W:
    # N=512 f64, 512·512 rows, ms: torch.fft.fft, fft_radix2, fft_mxu, plain
    jnp_ms, radix2_ms, mxu_ms, plain_ms = 1.4158, 1.4970, 1.5099, 62.617
    assert pm.BACKEND_COMPUTE_WEIGHT == {
        "jnp": 1.0, "pallas": round(radix2_ms / jnp_ms, 3),
        "mxu": round(mxu_ms / jnp_ms, 3), "ref": round(plain_ms / jnp_ms, 1)}
    # ring_send: two (128, 128, 128) f64 blocks in 0.0264 ms
    assert pm.LINK_BYTES_PER_S == float(f"{2 * 128 ** 3 * 8 / 0.0264e-3:.2e}")
    # a wire copy's host launch path, 0.036-0.037 ms, for the RDMA rings;
    # the zero-payload intercepts the calibrate CLI measured on 4x1 for the
    # others
    assert pm.ENGINE_MESSAGE_OVERHEAD_S == {
        "pallas_ring": 36.5e-6, "bidi_ring": 36.5e-6,
        "switched": 3.41e-3, "torus": 4.90e-4, "overlap_ring": 1.61e-3}
    # none is the reference's TPU/FPGA prior
    assert pm.BACKEND_COMPUTE_WEIGHT != jpm.BACKEND_COMPUTE_WEIGHT
    assert pm.LINK_BYTES_PER_S != jpm.LINK_BYTES_PER_S
    for engine in ENGINES:
        assert pm.ENGINE_MESSAGE_OVERHEAD_S[engine] != \
            jpm.ENGINE_MESSAGE_OVERHEAD_S[engine]
    # with no calibration the lookups fall back to them
    pm.set_calibration(None)
    assert pm.active_calibration() is None
    for engine in ENGINES:
        assert pm.message_overhead_s(engine) == pm.ENGINE_MESSAGE_OVERHEAD_S[engine]
    for backend in BACKENDS:
        assert pm.backend_compute_weight(backend) == pm.BACKEND_COMPUTE_WEIGHT[backend]
    assert pm.link_bytes_per_s() == pm.LINK_BYTES_PER_S
    # ... and the model ranks the backends as the card does
    est = {b: pm.estimate_plan_seconds(512, 1, 1, backend=b) for b in BACKENDS}
    assert est["jnp"] < est["pallas"] < est["mxu"] < est["ref"]
