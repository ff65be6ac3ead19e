"""Serving on a 2×2 grid of rank processes (gloo on the CPU), the port's
counterpart of the reference's ``tests/_dist_serving_check.py``.

Rank 0 holds the :class:`~repro_torch.serving.SimServer`'s scheduler;
the other ranks follow its batches.  On each of the five engines, three
heat requests (3, 2 and 1 steps, three amplitudes) batch into one lane
stack and an nls request, of another fingerprint, rides alone.  Every
lane's streamed history must be bitwise (exact float equality, ``t``
included) a solo 2×2 run of the same request, and every rank must serve
the same batches.  ``GlooWire.fuses`` is on, so on ``pallas_ring`` (fused
roundtrip) and ``bidi_ring`` the exchanges carry ``ring_payload``'s lanes
(its plain version here): a fold's lane-strided slab read in place and
the roundtrip's multiplier shared by the lanes, with the plain calls of
the solo steps.  A roundtrip multiplier that broadcasts over ky gives the
bits of the full one, solo and with lanes.
"""

import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch import dist
from repro_torch.core import spectral as sp
from repro_torch.core.fft3d import DiagonalKernel, spectral_roundtrip_local
from repro_torch.kernels import ring_rdma
from repro_torch.serving import SimRequest, SimServer, request_key, scaled_initial_fields
from repro_torch.serving import cli
from repro_torch.solvers import SolverState

N = 16
# chunks=5: heat's Y-pencil slab axis holds kx/Pu = 10/2 = 5 rows on 2x2,
# so the Y<->Z fold and roundtrip run 5 slabs and carry payloads
ENGINES = {
    "switched": {"comm_engine": "switched", "backend": "pallas"},
    "torus": {"comm_engine": "torus", "backend": "pallas"},
    "overlap_ring": {"comm_engine": "overlap_ring", "backend": "pallas",
                     "chunks": 5},
    "pallas_ring": {"comm_engine": "pallas_ring", "backend": "pallas",
                    "fused_roundtrip": True, "chunks": 5},
    "bidi_ring": {"comm_engine": "bidi_ring", "backend": "pallas", "chunks": 5},
}
FUSED = ("pallas_ring", "bidi_ring")


def _requests(cfg):
    heat = [SimRequest(case="heat", n=N, steps=steps, dtype="float64",
                       plan_cfg=cfg, scale=scale, request_id=f"heat-{i}")
            for i, (steps, scale) in enumerate(((3, 1.0), (2, 1.75), (1, 0.5)))]
    nls = SimRequest(case="nls", n=N, steps=2, dtype="float64", plan_cfg=cfg,
                     request_id="nls-0")
    return heat, nls


def _solo_history(solver, scale, steps):
    st = SolverState(fields=scaled_initial_fields(solver, scale))
    history = [solver.observables(st)]
    for _ in range(steps):
        st = solver.step(st)
        history.append(solver.observables(st))
    return history


def _counts():
    return ring_rdma.plain_calls, ring_rdma.payload_copies


def _serve_side(ctx):
    for dim in ("u", "v"):
        wire = ctx.wire(dim, "cpu")
        if wire is not None:
            wire.fuses = True
    out = {}
    for name, cfg in ENGINES.items():
        heat, nls = _requests(cfg)
        server = SimServer(ctx.grid(), device="cpu", max_batch=4,
                           use_plan_cache=False)
        results = batched = None
        if ctx.rank == 0:
            tickets = [server.submit(r) for r in (*heat, nls)]
            c0 = _counts()
            assert server.serve_once() == 3           # the heat lanes
            batched = [a - b for a, b in zip(_counts(), c0)]
            server.serve_pending()
            server.close()
            results = [t.result(timeout=60) for t in tickets]
            results = [(r.ok, r.error, r.batch_size, r.history) for r in results]
        else:
            server.follow()
        # the solo 2x2 runs of the same requests, on every rank
        c0 = _counts()
        solos = [_solo_history(server.registry.get(r), r.scale, r.steps)
                 for r in heat]
        solo = [a - b for a, b in zip(_counts(), c0)]
        solos.append(_solo_history(server.registry.get(nls), nls.scale, nls.steps))
        out[name] = {"results": results, "solos": solos,
                     "batch_log": server.batch_log, "batched": batched,
                     "solo": solo, "engines": len(server.registry)}
    out["broadcast"] = _broadcast_multiplier(ctx)
    return out


def _broadcast_multiplier(ctx):
    """The fused roundtrip with a multiplier of shape (kx, 1, Nz), which
    broadcasts over ky, against the same multiplier expanded to the full
    Z-pencil shape: (bitwise equal?, payload calls) for a solo field and
    for a stack of 2 lanes.  N=32: a rank's 9 kx rows in 3 slabs of 3, so
    a slab's multiplier holds several kx rows."""
    cfg = {**ENGINES["pallas_ring"], "chunks": 3}
    server = SimServer(ctx.grid(), device="cpu", use_plan_cache=False)
    solver = server.registry.get(SimRequest(case="heat", n=32, steps=1,
                                            dtype="float64", plan_cfg=cfg))
    plan = solver.plan
    shape = sp.k_squared(plan, torch.float64, device="cpu").shape
    gen = torch.Generator().manual_seed(ctx.rank)
    d = 0.5 + torch.rand(shape[0], 1, shape[2], generator=gen, dtype=torch.float64)
    full = DiagonalKernel(dr=d.expand(shape).contiguous())
    lanes = torch.stack([scaled_initial_fields(solver, s)[0] for s in (1.0, 1.5)])
    out = {}
    for name, u in (("solo", lanes[0]), ("lanes", lanes)):
        c0 = ring_rdma.plain_calls
        got = spectral_roundtrip_local(plan, DiagonalKernel(dr=d), u)
        out[name] = (torch.equal(got, spectral_roundtrip_local(plan, full, u)),
                     ring_rdma.plain_calls - c0)
    return out


@pytest.fixture(scope="module")
def ranks():
    return dist.run_ranks(_serve_side, 2, 2, device="cpu")


@pytest.mark.parametrize("engine", ENGINES)
def test_lanes_are_bitwise_solo_runs_on_the_grid(ranks, engine):
    heat, nls = _requests(ENGINES[engine])
    r0 = ranks[0][engine]
    assert [b for _, _, b, _ in r0["results"]] == [3, 3, 3, 1]
    for (ok, err, _, hist), solo, req in zip(r0["results"], r0["solos"],
                                             (*heat, nls)):
        assert ok, err
        assert len(hist) == req.steps + 1
        assert hist == solo, req.request_id        # bitwise, "t" included
    # every rank served the same batches: heat's three lanes, then nls alone
    want = [(request_key(heat[0]), ("heat-0", "heat-1", "heat-2")),
            (request_key(nls), ("nls-0",))]
    for r in ranks:
        assert r[engine]["batch_log"] == want
        assert r[engine]["engines"] == 2
        assert r[engine]["solos"] == r0["solos"]   # all-reduced observables


@pytest.mark.parametrize("engine", FUSED)
def test_fused_engines_run_the_payloads_lanes(ranks, engine):
    r0 = ranks[0][engine]
    # the heat batch's 3 steps against the solo runs' 3 + 2 + 1: a batched
    # step makes the payload calls (and copies) of one solo step
    (calls, copies), (solo_calls, solo_copies) = r0["batched"], r0["solo"]
    assert calls > 0 and 2 * calls == solo_calls
    assert 2 * copies == solo_copies


def test_fused_roundtrip_takes_a_broadcast_multiplier(ranks):
    # the roundtrip payload reads a (kx, 1, Nz) multiplier as the full
    # (kx, ky, Nz) one, solo and with lanes, on every rank
    for r in ranks:
        for name in ("solo", "lanes"):
            same, calls = r["broadcast"][name]
            assert calls > 0, name
            assert same, name


def test_cli_serves_on_a_grid_of_ranks(capfd):
    assert cli.main(["--case", "heat", "--n", "16", "--mesh", "2x2",
                     "--requests", "4", "--max-batch", "2", "--validate",
                     "--device", "cpu", "--dtype", "float64"]) == 0
    out = capfd.readouterr().out
    assert "mesh=2x2" in out and "validate: OK (4 streamed histories)" in out
    assert out.count(" batch=2 ") == 4 and out.count("served 4 requests") == 1
