"""Port parity of the serving layer (``repro_torch.serving``) on a 1×1 grid.

* the reference's ``tests/test_serving.py`` on the port, test for test:
  the fingerprint contract, queue batching and fairness, registry reuse,
  the batched-vs-solo identity, streaming order, backpressure,
  load-generator stats and the serving metrics;
* ``request_key`` is the reference's, key for key;
* the batched step of the four cases at N=16 f64 on the ``"pallas"``,
  ``"jnp"`` and ``"mxu"`` backends: every lane of a batch of 3 bitwise
  (exact float equality, ``t`` included) its solo port run, with the plain
  calls of one solo step a batched step; and each lane within 1e-10
  (``observables_rel_err``) of a solo run of the JAX package;
* ``ring_payload``'s lanes on its plain version: a lane-strided slab and
  a multiplier shared by every lane give each lane a solo payload's bits.
"""

import numpy as np
import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch import obs
from repro_torch.core import decomposition as dec
from repro_torch.kernels import fft_mxu, fft_radix2, ref, ring_rdma
from repro_torch.serving import (EngineRegistry, LoadReport, QueueFullError,
                                 RequestQueue, SimRequest, SimResult, SimServer,
                                 StepUpdate, Ticket, percentile_us, request_key,
                                 run_load, scaled_initial_fields)
from repro_torch.solvers import SolverState, make_solver
from repro_torch.solvers.base import observables_rel_err

GRID = dec.PencilGrid.from_mesh(1, 1)


@pytest.fixture(scope="module")
def grid11():
    return GRID


def _server(**kw):
    kw.setdefault("use_plan_cache", False)
    return SimServer(GRID, device="cpu", **kw)


def _req(**kw):
    base = dict(case="heat", n=8, steps=2, dtype="float64")
    base.update(kw)
    return SimRequest(**base)


def _ticket(seq, **kw):
    req = _req(**kw)
    return Ticket(req, request_key(req), seq)


# ---------------------------------------------------------------------------
# fingerprint contract
# ---------------------------------------------------------------------------

def test_request_key_ignores_per_request_knobs():
    # steps / scale / request_id never enter the fingerprint: requests
    # differing only there share one engine and batch together
    a = _req(steps=1, scale=1.0, request_id="a")
    b = _req(steps=7, scale=2.5, request_id="b")
    assert request_key(a) == request_key(b)


def test_request_key_separates_engine_shaping_fields():
    base = request_key(_req())
    assert request_key(_req(case="nls")) != base
    assert request_key(_req(n=16)) != base
    assert request_key(_req(dtype="float32")) != base
    assert request_key(_req(params={"kappa": 0.5})) != base
    assert request_key(_req(plan_cfg={"comm_engine": "torus"})) != base


def test_request_key_normalizes_plan_cfg_spellings():
    # the tuning layer's legacy knob mapping (net -> comm_engine) applies
    # before hashing, so equivalent spellings collide onto one key
    a = _req(plan_cfg={"net": "torus"})
    b = _req(plan_cfg={"comm_engine": "torus"})
    assert request_key(a) == request_key(b)
    key = request_key(a)
    assert key.startswith("heat_n8x8x8_float64_")


@pytest.mark.parametrize("kw", [
    {}, {"case": "nls", "n": 16, "dtype": "float32"}, {"n": (8, 16, 32)},
    {"params": {"kappa": 0.5, "mode": [1, 1, 0]}, "steps": 5, "scale": 3.0},
    {"plan_cfg": {"net": "torus", "chunks": 3}},
    {"plan_cfg": {"comm_engine": "pallas_ring", "backend": "pallas",
                  "fused_roundtrip": True}, "request_id": "x"},
])
def test_request_key_is_the_references(kw):
    from repro.serving import SimRequest as JSimRequest
    from repro.serving import request_key as jrequest_key

    base = dict(case="heat", n=8, steps=2, dtype="float64")
    base.update(kw)
    assert request_key(SimRequest(**base)) == jrequest_key(JSimRequest(**base))


# ---------------------------------------------------------------------------
# queue: lanes, fairness, backpressure
# ---------------------------------------------------------------------------

def test_queue_groups_by_fingerprint_and_drains_in_arrival_order():
    q = RequestQueue()
    t1 = _ticket(1, request_id="h1")
    t2 = _ticket(2, case="nls", request_id="n1")
    t3 = _ticket(3, request_id="h2")
    for t in (t1, t2, t3):
        q.submit(t)
    assert q.depth == 3
    assert sorted(q.lanes().values()) == [1, 2]
    # lane of the globally oldest head first (heat, seq 1), FIFO within it
    batch = q.next_batch(8)
    assert [t.request.request_id for t in batch] == ["h1", "h2"]
    assert q.next_batch(8) == [t2]
    assert q.next_batch(8) == [] and q.depth == 0


def test_queue_fairness_oldest_head_wins_even_in_smaller_lane():
    q = RequestQueue()
    q.submit(_ticket(1, case="nls"))          # oldest overall
    q.submit(_ticket(2, request_id="h1"))     # bigger lane, younger head
    q.submit(_ticket(3, request_id="h2"))
    first = q.next_batch(8)
    assert [t.request.case for t in first] == ["nls"]


def test_queue_max_batch_caps_the_drain():
    q = RequestQueue()
    for i in range(5):
        q.submit(_ticket(i + 1, request_id=f"r{i}"))
    assert len(q.next_batch(2)) == 2
    assert q.depth == 3


def test_queue_backpressure_rejects_above_max_pending():
    q = RequestQueue(max_pending=2)
    q.submit(_ticket(1))
    q.submit(_ticket(2))
    with pytest.raises(QueueFullError, match="max_pending=2"):
        q.submit(_ticket(3))
    assert q.depth == 2  # the rejected ticket never entered
    with pytest.raises(ValueError, match="max_pending"):
        RequestQueue(max_pending=0)


def test_queue_rejection_carries_retry_hint():
    q = RequestQueue(max_pending=2, retry_hint_s=0.1)
    q.submit(_ticket(1))
    q.submit(_ticket(2))
    with pytest.raises(QueueFullError) as e:
        q.submit(_ticket(3))
    # depth == bound at rejection: hint is exactly the base
    assert e.value.retry_after_hint == pytest.approx(0.1)


# ---------------------------------------------------------------------------
# registry: one live engine per fingerprint
# ---------------------------------------------------------------------------

def test_registry_reuses_the_same_engine_instance(grid11):
    reg = EngineRegistry(grid11, device="cpu", use_plan_cache=False)
    a = reg.get(_req(steps=1, request_id="a"))
    b = reg.get(_req(steps=9, request_id="b"))   # same fingerprint
    assert a is b and len(reg) == 1              # one shared solver
    c = reg.get(_req(params={"kappa": 0.5}))
    assert c is not a and len(reg) == 2
    assert c.params()["kappa"] == 0.5


def test_registry_picks_up_autotuned_plan_from_cache(grid11, tmp_path):
    from repro_torch.tuning.cache import PlanCache

    cache = str(tmp_path / "plans.json")
    probe = EngineRegistry(grid11, device="cpu", use_plan_cache=False).get(_req())
    PlanCache(cache).put(probe.problem_key(),
                         {"best": {"comm_engine": "torus"}})
    reg = EngineRegistry(grid11, device="cpu", use_plan_cache=True,
                         cache_path=cache)
    solver = reg.get(_req())
    assert solver.plan.comm_engine == "torus"
    # an explicit plan_cfg bypasses the cache consult entirely
    pinned = reg.get(_req(plan_cfg={"comm_engine": "switched"}))
    assert pinned.plan.comm_engine == "switched"


# ---------------------------------------------------------------------------
# server: batched == solo, streaming, run-to-longest
# ---------------------------------------------------------------------------

def _solo_history(solver, scale, steps):
    st = SolverState(fields=scaled_initial_fields(solver, scale))
    history = [solver.observables(st)]
    for _ in range(steps):
        st = solver.step(st)
        history.append(solver.observables(st))
    return history


def test_batched_histories_identical_to_solo_runs():
    server = _server(max_batch=8)
    reqs = [_req(steps=2, scale=1.0, request_id="r0"),
            _req(steps=3, scale=1.5, request_id="r1"),
            _req(steps=1, scale=2.0, request_id="r2")]
    tickets = [server.submit(r) for r in reqs]
    assert server.serve_pending() == 3
    solver = server.registry.get(reqs[0])
    for req, ticket in zip(reqs, tickets):
        res = ticket.result(timeout=5)
        assert res.ok and res.batch_size == 3
        assert len(res.history) == req.steps + 1
        # bitwise: float(...) == float(...) per observable, including "t"
        assert res.history == _solo_history(solver, req.scale, req.steps)


def test_ticket_streams_updates_in_step_order():
    server = _server()
    ticket = server.submit(_req(steps=3))
    server.serve_pending()
    updates = list(ticket.updates(timeout=5))
    assert [u.step for u in updates] == [0, 1, 2, 3]
    assert all(isinstance(u, StepUpdate) for u in updates)
    assert updates[1].t == pytest.approx(updates[3].t / 3)
    assert ticket.done
    res = ticket.result()
    assert isinstance(res, SimResult) and res.latency_s >= 0
    assert [u.observables for u in updates] == res.history


def test_run_to_longest_finishes_short_lanes_at_their_horizon():
    # lanes with differing steps batch; each gets exactly steps+1 entries
    server = _server()
    short = server.submit(_req(steps=0, request_id="short"))
    long = server.submit(_req(steps=4, request_id="long"))
    assert server.serve_once() == 2
    assert len(short.result().history) == 1      # just the t=0 diagnostics
    assert len(long.result().history) == 5


def test_server_pushes_error_result_instead_of_dying():
    server = _server()
    ticket = server.submit(_req(case="burgers", request_id="bad"))
    assert server.serve_once() == 1
    res = ticket.result(timeout=5)
    assert not res.ok and "unknown solver case" in res.error
    assert res.history == []
    # the lane's death left a structured record (the fleet's shared type)
    from repro_torch.fleet.records import FailureRecord
    assert len(server.failures) == 1
    rec = server.failures[0]
    assert isinstance(rec, FailureRecord)
    assert rec.kind == "batch_error" and rec.where == "serving.batch"
    assert rec.job_id == "bad" and not rec.retryable
    assert "unknown solver case" in rec.detail
    # the failed batch didn't wedge the server
    ok = server.submit(_req())
    server.serve_pending()
    assert ok.result(timeout=5).ok


def test_server_backpressure_and_validation():
    server = _server(max_pending=1)
    server.submit(_req())
    with pytest.raises(QueueFullError):
        server.submit(_req())
    with pytest.raises(ValueError, match="steps"):
        server.submit(_req(steps=-1))
    with pytest.raises(ValueError, match="max_batch"):
        SimServer(GRID, device="cpu", max_batch=0)


def test_threaded_server_serves_submissions():
    server = _server()
    server.start()
    try:
        assert server.running
        tickets = [server.submit(_req(request_id=f"r{i}", scale=1.0 + i))
                   for i in range(3)]
        results = [t.result(timeout=30) for t in tickets]
        assert all(r.ok for r in results)
    finally:
        server.stop()
    assert not server.running


# ---------------------------------------------------------------------------
# load generator + metrics
# ---------------------------------------------------------------------------

def test_percentile_nearest_rank():
    lat = [1.0, 2.0, 3.0, 4.0]      # already in µs, nearest-rank convention
    assert percentile_us(lat, 0.50) == 2.0
    assert percentile_us(lat, 0.99) == 4.0
    assert percentile_us([], 0.5) == 0.0


def test_run_load_burst_stats():
    server = _server()
    reqs = [_req(request_id=f"r{i}", scale=1.0 + 0.5 * i) for i in range(4)]
    report = run_load(server, reqs)
    assert isinstance(report, LoadReport)
    s = report.stats()
    assert s["n_requests"] == 4 and s["n_failed"] == 0
    assert s["requests_per_s"] > 0
    assert s["p50_us"] <= s["p95_us"] <= s["p99_us"]


def test_serving_metrics_counters_and_gauges():
    with obs.capture() as (tracer, metrics):
        server = _server(max_batch=2)
        tickets = [server.submit(_req(request_id=f"r{i}")) for i in range(3)]
        server.serve_pending()
        for t in tickets:
            assert t.result(timeout=5).ok
    c = metrics.counters()
    assert c["serving.requests.submitted"] == 3
    assert c["serving.requests.admitted"] == 3
    assert c["serving.requests.completed"] == 3
    assert c["serving.batches"] == 2             # 3 requests, max_batch 2
    assert c["serving.engine_cache.misses"] == 1
    assert c["serving.engine_cache.hits"] == 1   # second batch, warm engine
    g = metrics.gauges()
    assert g["serving.queue_depth"] == 0
    assert g["serving.batch_size"] in (1, 2)
    names = [e["name"] for e in tracer.events()]
    assert names.count("serve/admit") == 2
    assert names.count("dispatch/serving.batch_step") == 4   # 2 batches x 2 steps


def test_run_load_retries_backpressure_within_budget():
    # a burst 3x the queue bound: every rejection is retried after a drain
    # pass, so nothing is shed and nothing is lost
    server = _server(max_pending=1)
    reqs = [_req(request_id=f"r{i}", scale=1.0 + 0.5 * i) for i in range(3)]
    report = run_load(server, reqs, max_submit_retries=2,
                      retry_backoff_s=0.001)
    assert len(report.results) == 3 and all(r.ok for r in report.results)
    assert report.n_rejected == 0 and report.submit_retries == 2
    assert report.stats()["submit_retries"] == 2


def test_run_load_records_rejections_after_budget():
    from repro_torch.fleet.records import FailureRecord

    server = _server(max_pending=1)
    reqs = [_req(request_id=f"r{i}") for i in range(3)]
    report = run_load(server, reqs)          # max_submit_retries=0: shed
    assert len(report.results) == 1 and report.n_rejected == 2
    assert report.n_requests == 3            # shed load still counted
    for rec in report.rejected:
        assert isinstance(rec, FailureRecord)
        assert rec.kind == "rejected" and rec.where == "serving.queue"
    assert [r.job_id for r in report.rejected] == ["r1", "r2"]
    assert report.stats()["n_rejected"] == 2


def test_rejected_counter_on_backpressure():
    with obs.capture() as (_, metrics):
        server = _server(max_pending=1)
        server.submit(_req())
        with pytest.raises(QueueFullError):
            server.submit(_req())
    assert metrics.counters()["serving.requests.rejected"] == 1


# ---------------------------------------------------------------------------
# the batched step: bitwise per lane, the solo step's calls, JAX parity
# ---------------------------------------------------------------------------

CASES = ("heat", "nls", "poisson", "navier_stokes")
BACKENDS = ("pallas", "jnp", "mxu")
N, STEPS, SCALES = 16, 2, (1.0, 1.5, 2.0)


def _counts():
    return (ref.calls, fft_mxu.plain_calls, ring_rdma.plain_calls,
            fft_radix2.launches, fft_mxu.launches, ring_rdma.payload_launches)


@pytest.fixture(scope="module")
def jax_histories():
    """Solo histories of the JAX package, per case and scale (its default
    plan), read on first use."""
    from repro import compat
    from repro.serving import scaled_initial_fields as jscaled
    from repro.solvers import SolverState as JSolverState
    from repro.solvers import make_solver as jmake_solver

    mesh = compat.make_mesh((1, 1), ("data", "model"))
    cache = {}

    def get(case):
        if case not in cache:
            js = jmake_solver(case, mesh, N, dtype="float64")
            hists = []
            for scale in SCALES:
                st = JSolverState(fields=jscaled(js, scale))
                hist = [js.observables(st)]
                for _ in range(STEPS):
                    st = js.step(st)
                    hist.append(js.observables(st))
                hists.append(hist)
            cache[case] = hists
        return cache[case]
    return get


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES)
def test_batched_lanes_are_bitwise_solo_runs(jax_histories, case, backend):
    server = _server(max_batch=4)
    reqs = [SimRequest(case=case, n=N, steps=STEPS, dtype="float64",
                       plan_cfg={"backend": backend}, scale=s,
                       request_id=f"{case}-{i}") for i, s in enumerate(SCALES)]
    tickets = [server.submit(r) for r in reqs]
    assert server.serve_once() == 3
    solver = server.registry.get(reqs[0])
    solos = [_solo_history(solver, r.scale, r.steps) for r in reqs]
    # a batched step makes the calls of one solo step: no call a lane
    lanes = [scaled_initial_fields(solver, s) for s in SCALES]
    stack = tuple(torch.stack(xs) for xs in zip(*lanes))
    c0 = _counts()
    solver.batched_step(stack)
    c1 = _counts()
    for lane in lanes:
        solver.step(SolverState(fields=lane))
    batched = [a - b for a, b in zip(c1, c0)]
    solo = [(a - b) / len(lanes) for a, b in zip(_counts(), c1)]
    assert batched == solo and batched[3:] == [0, 0, 0]
    assert (sum(batched) > 0) == (backend != "jnp")   # torch.fft is not counted
    for ticket, hist, want in zip(tickets, solos, jax_histories(case)):
        res = ticket.result(timeout=5)
        assert res.ok and res.batch_size == 3
        assert res.history == hist           # bitwise, "t" included
        for got, ref_obs in zip(res.history, want):
            assert got["t"] == ref_obs["t"]
            assert observables_rel_err(got, ref_obs) <= 1e-10, (got, ref_obs)
        ok, lines = solver.validate(res.history)
        assert ok, lines


def test_batched_step_refuses_a_stack_without_a_lane_axis():
    s = make_solver("heat", GRID, 8, device="cpu")
    with pytest.raises(ValueError, match="leading lane axis"):
        s.batched_step(s.initial_fields())
    stack = tuple(torch.stack([f, 2 * f]) for f in s.initial_fields())
    obs_ = s.batched_observables(s.batched_step(stack))
    assert {k: len(v) for k, v in obs_.items()} == {"amp": 2, "mean": 2,
                                                      "energy": 2}


# ---------------------------------------------------------------------------
# ring_payload's lanes (its plain version here)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["forward", "inverse", "roundtrip"])
def test_payload_lanes_give_each_lane_a_solo_payloads_bits(mode):
    rng = np.random.default_rng(7)
    stack = [torch.from_numpy(rng.standard_normal((3, 8, 5, 16))) for _ in range(2)]
    xr, xi = (t[:, 2:6] for t in stack)              # a narrowed slab
    assert not xr.is_contiguous()
    assert ring_rdma.lane_rows_of(xr) == 20
    assert ring_rdma.as_lanes(xr, 20).shape == (3, 20, 16)
    diag = tuple(torch.from_numpy(rng.standard_normal((4, 5, 16)))
                 for _ in range(2)) if mode == "roundtrip" else None
    plain = ring_rdma.plain_calls
    kr, ki = ring_rdma.ring_payload(xr, xi, diag=diag, inverse=mode == "inverse")
    assert ring_rdma.plain_calls == plain + 1
    for b in range(3):
        sr, si = ring_rdma.ring_payload(xr[b].contiguous(), xi[b].contiguous(),
                                        diag=diag, inverse=mode == "inverse")
        assert torch.equal(sr, kr[b]) and torch.equal(si, ki[b])
    if diag is not None:   # the multiplier has the payload's trailing shape
        with pytest.raises(ValueError, match="trailing shape"):
            ring_rdma.ring_payload(xr, xi, diag=(diag[0][:2], diag[1][:2]))


def test_lane_layout_of_payload_views():
    x = torch.arange(4 * 6 * 8, dtype=torch.float64).reshape(4, 6, 8)
    assert ring_rdma.as_lanes(x, 24) is not None
    assert ring_rdma.as_lanes(x.transpose(0, 1), 24) is None
    assert ring_rdma.lane_rows_of(x.transpose(0, 1)) == 1
    assert ring_rdma.lane_rows_of(x[..., ::2]) == 0
