"""``repro_torch.obs`` against ``repro.obs``: the tests of ``tests/test_obs.py`` on
the port's copy (span nesting and attributes, the disabled-path no-op
guarantees, counters and gauges, the Chrome-trace export, and the two
timing tests of ``repro_torch.tuning.timing``: ``time_stats`` and the
donated-buffer guard), the two packages' documents for the same spans, and
the port's instrumentation: a ``dispatch/...`` span waits for the card (and
for nothing on the CPU), the solver step and ``make_fft3d``'s entry points
are spans carrying the perf model's ``model_predicted_us`` and the fold
phases its ``model_wire_us``, each equal to the reference's under one
calibration, and the CLI's ``--trace`` writes a valid trace on a 2×2 mesh
of ranks.
"""

import json
import threading

import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro import obs as jobs
from repro.core import perfmodel as jpm
from repro_torch import obs
from repro_torch.core import perfmodel as pm
from repro_torch.core.decomposition import PencilGrid
from repro_torch.core.fft3d import make_fft3d
from repro_torch.solvers import cli, make_solver

# one calibration for both packages' models (every engine, backend and the
# wire rate measured), so the model attributes of the spans compare equal
CALIBRATION = {
    "engine_message_overhead_s": {"switched": 3.1e-5, "torus": 4.7e-5,
                                  "overlap_ring": 2.9e-5,
                                  "pallas_ring": 1.3e-5, "bidi_ring": 1.1e-5},
    "backend_compute_weight": {"jnp": 1.0, "ref": 37.5, "pallas": 1.21,
                               "mxu": 0.93},
    "link_bytes_per_s": 3.3e11,
}


@pytest.fixture(autouse=True)
def _obs_reset():
    # every test starts and ends disabled with empty global state, however
    # the test body left it
    obs.disable()
    obs.clear()
    pm.set_calibration(CALIBRATION)
    jpm.set_calibration(CALIBRATION)
    yield
    obs.disable()
    obs.clear()
    pm.set_calibration(None)
    jpm.set_calibration(None)


def _jax_mesh_1x1():
    from repro import compat
    return compat.make_mesh((1, 1), ("data", "model"))


# ---------------------------------------------------------------------------
# disabled path: the zero-overhead contract
# ---------------------------------------------------------------------------

def test_disabled_span_is_shared_noop_singleton():
    assert not obs.is_enabled()
    s = obs.span("dispatch/x")
    assert s is obs.NULL_SPAN
    # attrs are accepted and dropped without recording anything
    with obs.span("dispatch/x", engine="torus") as sp:
        sp.set_attr(late=1)
    assert obs.tracer.events() == []


def test_disabled_metrics_record_nothing():
    obs.metrics.inc("comm.wire_bytes", 1024)
    obs.metrics.set_gauge("g", 3.0)
    assert obs.metrics.counters() == {}
    assert obs.metrics.gauges() == {}
    assert obs.metrics.get("comm.wire_bytes") == 0
    assert obs.metrics.get("missing", default=-1) == -1


def test_disabled_traced_call_is_transparent():
    calls = []

    def fn(a, b=0):
        calls.append((a, b))
        return a + b

    fn.custom_marker = "still-reachable"
    wrapped = obs.traced_call(fn, "dispatch/fn")
    assert wrapped(1, b=2) == 3
    assert calls == [(1, 2)]
    assert obs.tracer.events() == []
    # attribute access forwards to the wrapped function
    assert wrapped.custom_marker == "still-reachable"


# ---------------------------------------------------------------------------
# enabled path: nesting, attributes, threads
# ---------------------------------------------------------------------------

def test_span_nesting_records_parent_and_depth():
    obs.enable()
    with obs.span("dispatch/outer", engine="torus"):
        with obs.span("trace/inner", round=3) as sp:
            sp.set_attr(bytes=64)
    events = {e["name"]: e for e in obs.tracer.events()}
    assert set(events) == {"dispatch/outer", "trace/inner"}
    outer, inner = events["dispatch/outer"], events["trace/inner"]
    assert outer["parent"] == "" and outer["depth"] == 0
    assert inner["parent"] == "dispatch/outer" and inner["depth"] == 1
    assert inner["args"] == {"round": 3, "bytes": 64}
    assert outer["args"] == {"engine": "torus"}
    # the inner interval sits inside the outer one
    assert inner["ts"] >= outer["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6


def test_span_stacks_are_per_thread():
    obs.enable()
    ready = threading.Event()

    def worker():
        with obs.span("dispatch/worker"):
            ready.set()

    with obs.span("dispatch/main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    events = {e["name"]: e for e in obs.tracer.events()}
    # the worker's span must not see the main thread's open span as parent
    assert events["dispatch/worker"]["parent"] == ""
    assert events["dispatch/worker"]["tid"] != events["dispatch/main"]["tid"]


def test_traced_call_records_dispatch_span_with_attrs():
    obs.enable()
    wrapped = obs.traced_call(lambda x: x * 2, "dispatch/fft3d.fwd",
                              attrs={"engine": "switched"})
    assert wrapped(21) == 42
    (ev,) = obs.tracer.events()
    assert ev["name"] == "dispatch/fft3d.fwd"
    assert ev["args"] == {"engine": "switched"}
    assert ev["dur"] >= 0


def test_capture_enables_then_disables():
    with obs.capture() as (tracer, metrics):
        assert obs.is_enabled()
        with obs.span("dispatch/x"):
            metrics.inc("k", 2)
    assert not obs.is_enabled()
    # recorded state stays readable after capture exits
    assert [e["name"] for e in tracer.events()] == ["dispatch/x"]
    assert metrics.get("k") == 2


def test_metrics_counters_accumulate_and_gauges_overwrite():
    obs.enable()
    obs.metrics.inc("comm.exchanges.data")
    obs.metrics.inc("comm.exchanges.data")
    obs.metrics.inc("comm.wire_bytes", 640)
    obs.metrics.set_gauge("link_bytes_per_s", 1e9)
    obs.metrics.set_gauge("link_bytes_per_s", 2e9)
    assert obs.metrics.get("comm.exchanges.data") == 2
    assert obs.metrics.get("comm.wire_bytes") == 640
    assert obs.metrics.get("link_bytes_per_s") == 2e9
    snap = obs.metrics.snapshot()
    assert snap["counters"]["comm.wire_bytes"] == 640
    assert snap["gauges"] == {"link_bytes_per_s": 2e9}


# ---------------------------------------------------------------------------
# Chrome-trace export (the document Perfetto / chrome://tracing load)
# ---------------------------------------------------------------------------

def test_chrome_trace_document_schema(tmp_path):
    obs.enable()
    with obs.span("dispatch/fft3d.fwd", engine="torus"):
        with obs.span("trace/fft3d.fold_xy", grid_dim="u"):
            pass
    obs.metrics.inc("comm.wire_bytes", 128)
    obs.disable()

    path = str(tmp_path / "trace.json")
    obs.write_chrome_trace(path, obs.tracer, obs.metrics,
                           meta={"devices": 8})
    with open(path) as f:
        doc = json.load(f)
    assert obs.validate_chrome_trace(doc) == []
    assert doc["displayTimeUnit"] == "ms"
    assert doc["meta"] == {"devices": 8}
    assert doc["metrics"]["counters"]["comm.wire_bytes"] == 128
    events = {e["name"]: e for e in doc["traceEvents"]}
    assert set(events) == {"dispatch/fft3d.fwd", "trace/fft3d.fold_xy"}
    ev = events["trace/fft3d.fold_xy"]
    assert ev["ph"] == "X" and ev["cat"] == "trace"
    assert ev["args"]["grid_dim"] == "u"
    assert ev["args"]["parent"] == "dispatch/fft3d.fwd"
    assert events["dispatch/fft3d.fwd"]["cat"] == "dispatch"


def test_validate_chrome_trace_flags_malformed_documents():
    assert obs.validate_chrome_trace({}) != []
    assert obs.validate_chrome_trace({"traceEvents": {}}) != []
    bad_event = {"traceEvents": [{"name": "x", "ph": "B", "ts": 0.0,
                                  "dur": 1.0, "pid": 1, "tid": 1}]}
    assert any("ph" in p for p in obs.validate_chrome_trace(bad_event))
    missing_key = {"traceEvents": [{"name": "x", "ph": "X"}]}
    assert obs.validate_chrome_trace(missing_key) != []


def test_summary_table_lists_spans_and_counters():
    obs.enable()
    with obs.span("dispatch/solver.step"):
        pass
    obs.metrics.inc("plan_cache.hits")
    obs.disable()
    table = obs.summary_table(obs.tracer, obs.metrics)
    assert "dispatch/solver.step" in table
    assert "plan_cache.hits" in table
    empty = obs.summary_table(obs.Tracer(), obs.Metrics())
    assert "no spans" in empty


# ---------------------------------------------------------------------------
# the two packages, and the port's instrumentation
# ---------------------------------------------------------------------------

def test_both_packages_export_the_same_document():
    events = [{"name": "dispatch/solver.step", "ts": 10.0, "dur": 5.5, "tid": 7,
               "parent": "", "depth": 0, "args": {"case": "heat"}},
              {"name": "trace/fft3d.fold_xy", "ts": 11.0, "dur": 1.25, "tid": 7,
               "parent": "dispatch/solver.step", "depth": 1,
               "args": {"grid_dim": "u", "dim_sizes": [2, 2]}}]
    docs, tables = [], []
    for pkg in (obs, jobs):
        tracer, metrics = pkg.Tracer(), pkg.Metrics()
        for ev in events:
            tracer._record(dict(ev))
        pkg.enable()
        metrics.inc("comm.wire_bytes", 96)
        metrics.set_gauge("checkpoint.restore_us", 3.0)
        pkg.disable()
        docs.append(pkg.chrome_trace(tracer, metrics, meta={"mesh": "2x2x2"}))
        tables.append(pkg.summary_table(tracer, metrics))
    assert docs[0] == docs[1] and tables[0] == tables[1]
    assert jobs.validate_chrome_trace(docs[0]) == []


def test_dispatch_span_waits_for_the_card_of_each_cuda_result(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)

    class OnCard:  # what the wait reads of a CUDA tensor
        is_cuda = True

        def __init__(self, index):
            self.device = torch.device("cuda", index)

    obs.enable()
    obs.traced_call(lambda: (torch.ones(2), [torch.zeros(1)]), "dispatch/cpu")()
    assert synced == []  # CPU tensors: nothing to wait for
    obs.traced_call(lambda: {"a": (OnCard(0), OnCard(1)), "b": OnCard(0)},
                    "dispatch/card")()
    assert sorted(d.index for d in synced) == [0, 1]
    assert [e["name"] for e in obs.tracer.events()] == ["dispatch/cpu", "dispatch/card"]


def test_solver_step_is_a_span_and_costs_nothing_disabled(monkeypatch):
    solver = make_solver("heat", PencilGrid.from_mesh(1, 1), 8, device="cpu",
                         plan_cfg={"fused_roundtrip": True})
    state = solver.init_state()

    def no_wait(_):
        raise AssertionError("a disabled step waited for the card")
    monkeypatch.setattr(obs, "synchronize", no_wait)
    state = solver.step(state)
    solver.observables(state)
    assert obs.tracer.events() == [] and obs.metrics.counters() == {}
    monkeypatch.undo()

    with obs.capture() as (tracer, _):
        state = solver.step(state)
        solver.observables(state)
    names = [e["name"] for e in tracer.events()]
    assert names.count("dispatch/solver.step") == 1
    assert names.count("dispatch/solver.observables") == 1
    step = next(e for e in tracer.events() if e["name"] == "dispatch/solver.step")
    from repro.solvers import make_solver as jmake_solver
    want = jmake_solver("heat", _jax_mesh_1x1(), 8,
                        plan_cfg={"fused_roundtrip": True}).predict_step_us()
    assert step["args"] == {"case": "heat", "engine": "switched",
                            "model_predicted_us": want}
    assert want > 0 and solver.predict_step_us() == want
    phases = {e["name"]: e for e in tracer.events() if e["name"].startswith("trace/")}
    assert set(phases) == {"trace/fft3d.fold_xy", "trace/fft3d.roundtrip_yz",
                           "trace/fft3d.unfold_xy"}
    assert phases["trace/fft3d.fold_xy"]["parent"] == "dispatch/solver.step"
    assert phases["trace/fft3d.fold_xy"]["args"] == {
        "engine": "switched", "grid_dim": "u", "dim_sizes": [1],
        "model_wire_us": 0.0}


def test_make_fft3d_entry_points_are_dispatch_spans():
    fwd, inv, _ = make_fft3d(PencilGrid.from_mesh(1, 1), 8, device="cpu")
    x = torch.randn(8, 8, 8, dtype=torch.float64)
    with obs.capture() as (tracer, _):
        inv(*fwd(x, torch.zeros_like(x)))
    events = tracer.events()
    top = [e for e in events if e["depth"] == 0]
    assert [e["name"] for e in top] == ["dispatch/fft3d.fwd", "dispatch/fft3d.inv"]
    from repro.core.fft3d import make_fft3d as jmake_fft3d
    jfwd, _, _ = jmake_fft3d(_jax_mesh_1x1(), 8)
    with jobs.capture() as (jtracer, _):
        jfwd(x.numpy(), x.numpy() * 0)
    (want,) = [e["args"] for e in jtracer.events() if e["name"] == "dispatch/fft3d.fwd"]
    assert top[0]["args"] == want
    assert set(want) == {"engine", "n", "mesh", "model_predicted_us"}
    assert want["model_predicted_us"] > 0
    nested = {e["name"]: e["parent"] for e in events if e["depth"] == 1}
    assert nested == {"trace/fft3d.fold_xy": "dispatch/fft3d.fwd",
                      "trace/fft3d.fold_yz": "dispatch/fft3d.fwd",
                      "trace/fft3d.unfold_yz": "dispatch/fft3d.inv",
                      "trace/fft3d.unfold_xy": "dispatch/fft3d.inv"}


def test_cli_trace_on_a_mesh_of_ranks(tmp_path, capfd):
    path = str(tmp_path / "trace.json")
    assert cli.main(["--case", "heat", "--n", "8", "--steps", "2", "--mesh", "2x2",
                     "--comm-engine", "pallas_ring", "--device", "cpu",
                     "--trace", path]) == 0
    out = capfd.readouterr().out
    assert out.count("wrote trace") == 1 and "dispatch/solver.step" in out
    with open(path) as f:
        doc = json.load(f)
    assert obs.validate_chrome_trace(doc) == []
    assert jobs.validate_chrome_trace(doc) == []
    names = [e["name"] for e in doc["traceEvents"]]
    assert names.count("dispatch/solver.step") == 2
    assert "trace/fft3d.fold_xy" in names
    counters = doc["metrics"]["counters"]
    assert counters["comm.wire_bytes"] > 0
    # rank 0's view of pallas_ring's single-axis rings on 2x2
    assert counters["comm.exchange_rounds.data"] == counters["comm.exchanges.data"]
    assert counters["comm.engine_exchange_rounds.pallas_ring"] > 0


@pytest.mark.parametrize("engine", ["switched", "torus", "overlap_ring",
                                    "pallas_ring", "bidi_ring"])
def test_fold_span_model_wire_us_equals_the_reference(engine):
    # each fold phase's span on 2x2, 4x2, 8x1 and the staged 2x2x2 (u over
    # two mesh axes), built by both packages' _phase_span
    from repro.core import decomposition as jdec
    from repro.core import fft3d as jfft3d
    from repro_torch.core import fft3d as fft3d

    for pu, pv, u_sizes, n in ((2, 2, (), 8), (4, 2, (), 16), (8, 1, (), 512),
                               (4, 2, (2, 2), 64)):
        u_axes = ("pod", "data") if u_sizes else ("data",)
        grids = (PencilGrid(pu=pu, pv=pv, u_axes=u_axes, u_sizes=u_sizes),
                 jdec.PencilGrid(pu=pu, pv=pv, u_axes=u_axes, u_sizes=u_sizes))
        plans = (fft3d.FFT3DPlan(n=(n, n, n), grid=grids[0], comm_engine=engine),
                 jfft3d.FFT3DPlan(n=(n, n, n), grid=grids[1], comm_engine=engine))
        for name, dim in (("trace/fft3d.fold_xy", "u"), ("trace/fft3d.fold_yz", "v")):
            args = []
            for pkg, mod, plan in ((obs, fft3d, plans[0]), (jobs, jfft3d, plans[1])):
                with pkg.capture() as (tracer, _):
                    with mod._phase_span(plan, name, dim):
                        pass
                (ev,) = tracer.events()
                args.append(ev["args"])
            assert args[0] == args[1], (pu, pv, u_sizes, name)
            assert (args[0]["model_wire_us"] > 0) == (pu > 1 if dim == "u" else pv > 1)


# ---------------------------------------------------------------------------
# timing helpers: percentile stats + the donated-buffer guard
# ---------------------------------------------------------------------------

def test_time_stats_distribution_keys_and_order():
    from repro_torch.tuning.timing import time_stats

    stats = time_stats(lambda x: x + 1, 1.0, iters=7)
    assert stats["iters"] == 7
    assert stats["min_us"] <= stats["p50_us"] <= stats["p95_us"]
    assert stats["mean_us"] > 0
    with pytest.raises(ValueError, match="iters"):
        time_stats(lambda x: x, 1.0, iters=0)


def test_timing_refuses_donated_inputs():
    from repro_torch.tuning.timing import time_stats, time_us

    class FakeDonated:
        deleted = False

        def is_deleted(self):
            return self.deleted

    def donating_fn(a):
        a.deleted = True  # what a jit with donate_argnums does on warm-up
        return 0.0

    with pytest.raises(ValueError, match="donated"):
        time_us(donating_fn, FakeDonated())
    with pytest.raises(ValueError, match="donated"):
        time_stats(donating_fn, FakeDonated())


def test_timing_waits_for_the_card_of_a_cuda_result(monkeypatch):
    from repro_torch.tuning.timing import time_stats, time_us

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)

    class OnCard:  # what the wait reads of a CUDA tensor
        is_cuda = True
        device = torch.device("cuda", 0)

    time_us(lambda: (OnCard(), torch.ones(1)), iters=3)
    assert len(synced) == 2  # after the warm-up, after the timed calls
    synced.clear()
    time_stats(lambda: [OnCard()], iters=3)
    assert len(synced) == 4  # after the warm-up and after every call
    synced.clear()
    time_us(lambda: torch.ones(1), iters=3)  # a CPU result is ready
    assert synced == []
