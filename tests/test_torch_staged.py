"""Port parity of the staged exchange on a 3-axis mesh: 2x2x2
``("pod", "data", "model")`` with ``u`` over ``("pod", "data")``, against
the JAX package on the same mesh (``tests/_dist_transpose_check.py 2x2x2``
and ``tests/_dist_fft_check.py --mesh 2x2x2``).

The port runs 8 gloo rank processes on the CPU, spawned once
(:func:`repro_torch.dist.run_ranks` with ``u_sizes=(2, 2)``); the JAX side
runs in a child process with 8 fake host devices (this file run as a
script) and hands its results over as ``.npz``.  Inputs come from numpy
with a seed, the same on both sides; N=8.  Held:

* every engine's relayouts bit for bit against JAX's ``switched`` fold,
  and ``unfold ∘ fold`` the identity bit for bit;
* one staged ring per mesh axis: a ``u`` fold costs the ring engines
  ``wire_rounds(2)`` on the ``pod`` wire and on the ``data`` wire (1 + 1),
  a ``v`` fold one ring over ``model``; ``switched`` one all-to-all round
  over the ``pod*data`` product group;
* the 3D FFT (c2c, pipelined, real) within 1e-10 of the largest entry of
  JAX's, and the fused schedules (the payload on its plain version, on the
  gloo wires) within 1e-10 of JAX's unfused ``pallas_ring`` roundtrip;
* the payload rides the first stage (the ``data`` ring, one round: the
  whole payload in one chunk) and no other;
* the wire counters of one forward transform on every rank follow
  ``check_wire_metrics`` (``tests/_dist_fft_check.py:56``), and rank 0's
  equal the counts JAX's trace of one transform records.  The one counter
  that differs by design: JAX's ``bidi_ring`` off a TPU falls back to
  ``ppermute`` streams, the port's runs its NIC engine (``rdma``).
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch import dist, obs
from repro_torch.core import comm
from repro_torch.core import transpose as tr
from repro_torch.core.decomposition import XY_STEP, YZ_STEP
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.core.fft3d import (DiagonalKernel, gather_pencil, make_fft3d,
                                    scatter_pencil, spectral_roundtrip_local)
from repro_torch.kernels import fft_radix2, ring_rdma

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = (2, 2, 2)  # ("pod", "data", "model")
PU, PV, U_SIZES = 4, 2, (2, 2)
N = (8, 8, 8)
ENGINES = ("switched", "torus", "overlap_ring", "pallas_ring", "bidi_ring")
FUSING = ("pallas_ring", "bidi_ring")
VARIANTS = ("c2c", "pipelined", "real")
TOL = 1e-10


def _inputs():
    """X-pencil inputs ``(Ny, Nz, Nx)``, three more for the identity check,
    and a Z-pencil multiplier ``(Nx, Ny, Nz)``."""
    rng = np.random.default_rng(222)
    d = {k: rng.standard_normal(N) for k in ("x", "xr", "xi", "x0", "x1", "x2")}
    d["dr"], d["di"] = (rng.standard_normal(N) for _ in range(2))
    return d


def _model(name):
    """Wire rounds per single-axis exchange of an engine's transport."""
    return {"switched": lambda q: 1, "bidi_ring": tr.bidi_rounds}.get(name, tr.ring_rounds)


# ---------------------------------------------------------------------------
# the JAX side (run as a script, in a child process with 8 fake devices)
# ---------------------------------------------------------------------------

def _jax_side(out: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    jax.config.update("jax_enable_x64", True)

    from repro import compat
    from repro import obs as jobs
    from repro.core import comm as jcomm
    from repro.core.decomposition import PencilGrid
    from repro.core.engine_spec import EngineSpec as JSpec
    from repro.core.fft3d import make_fft3d as jmake_fft3d

    mesh = compat.make_mesh(MESH, ("pod", "data", "model"))
    axes = dict(u_axes=("pod", "data"), v_axes=("model",))
    grid = PencilGrid.from_mesh(mesh, **axes)
    spec = grid.pencil_spec()
    d = _inputs()
    res = {}
    eng = jcomm.build_engine(JSpec(engine="switched"), grid)
    for which in ("xy", "yz"):
        f = jax.jit(compat.shard_map(
            lambda a, w=which: eng.fold(w, a), mesh=mesh, in_specs=(spec,),
            out_specs=spec, check_vma=False))
        res[f"fold_{which}"] = np.asarray(f(d["x"]))
    fwd, _, _ = jmake_fft3d(mesh, N, spec=JSpec(engine="switched"), **axes)
    kr, ki = fwd(d["xr"], d["xi"])
    res["c2c"] = np.asarray(kr) + 1j * np.asarray(ki)
    fwd, _, _ = jmake_fft3d(mesh, N, spec=JSpec(engine="switched", real=True), **axes)
    kr, ki = fwd(d["xr"])
    res["real"] = np.asarray(kr) + 1j * np.asarray(ki)
    # the composed roundtrip on JAX's (unfused) pallas_ring
    fwd, inv, _ = jmake_fft3d(mesh, N, spec=JSpec(engine="pallas_ring"), **axes)
    kr, ki = fwd(d["xr"], d["xi"])
    dr, di = d["dr"], d["di"]
    br, bi = inv(kr * dr - ki * di, kr * di + ki * dr)
    res["roundtrip"] = np.asarray(br) + 1j * np.asarray(bi)
    # the wire counters of one traced forward transform per engine
    for name in ENGINES:
        with jobs.capture() as (_, met):
            fwd, _, _ = jmake_fft3d(mesh, N, spec=JSpec(engine=name), **axes)
            fwd(d["xr"], d["xi"])
        res[f"metrics/{name}"] = np.array(json.dumps(met.counters()))
    np.savez(out, **res)


@pytest.fixture(scope="module")
def jax_results():
    """The JAX side's results, computed in a child process that starts with
    the module and runs while the port's ranks do (read on first use)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "jax.npz")
        child = subprocess.Popen([sys.executable, os.path.abspath(__file__), out],
                                 env=env, stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE, text=True)
        loaded = {}

        def get(key):
            if not loaded:
                _, err = child.communicate(timeout=600)
                assert child.returncode == 0, err[-3000:]
                with np.load(out) as z:
                    loaded.update(z)
            return loaded[key]
        yield get
        child.kill()
        child.communicate()


# ---------------------------------------------------------------------------
# the port's side (one process per rank)
# ---------------------------------------------------------------------------

def _wire_counts(ctx):
    return {f"{dim}/{label}": (w.exchanges, w.rounds)
            for (dim, label, kind), w in ctx.wires().items() if kind == "cpu"}


def _staged_payload(ctx, d):
    """A staged exchange over (pod, data) with a forward payload: the
    payload's plain version runs once (the data ring has one round), its
    result is the payload's, and the blocks are those of the exchange
    without it."""
    out = {}
    wires = ctx.axis_wires("u", "cpu")
    for w in wires:
        w.fuses = True
    x = [torch.from_numpy(d["x0"][:4, :, :]), torch.from_numpy(d["x1"][:4, :, :])]
    pr, pi = (torch.from_numpy(d[k][ctx.rank]) for k in ("x2", "xi"))
    twr, twi = fft_radix2.twiddles(8, torch.float64, torch.device("cpu"))
    want = ring_rdma.payload_plain(pr, pi, twr, twi)
    for name, fn in (("pallas_ring", ring_rdma.ring_exchange_rdma),
                     ("bidi_ring", ring_rdma.ring_exchange_bidi_rdma)):
        plain = ring_rdma.plain_calls
        got, (qr, qi) = fn(x, wires, split_axis=2, concat_axis=0, payload=(pr, pi))
        calls = ring_rdma.plain_calls - plain
        bare, _ = fn(x, wires, split_axis=2, concat_axis=0)
        out[name] = (calls, torch.equal(qr, want[0]) and torch.equal(qi, want[1]),
                     all(torch.equal(a, b) for a, b in zip(got, bare)))
    for w in wires:
        w.fuses = False
    return out


def _port_side(ctx):
    grid = ctx.grid()
    d = {k: torch.from_numpy(v) for k, v in _inputs().items()}

    def local(a):
        return scatter_pencil(a, grid).contiguous()

    def gathered(t):
        g = gather_pencil(t, grid)
        return None if g is None else g.numpy()

    arrays, flags, rounds, metrics = {}, {}, {}, {}
    for name in ENGINES:
        eng = comm.build_engine(EngineSpec(engine=name), grid)
        for step in (XY_STEP, YZ_STEP):
            arrays[f"{name}/fold_{step.name}"] = gathered(eng.fold_step(step, local(d["x"])))
            flags[f"{name}/identity_{step.name}"] = all(
                torch.equal(eng.unfold_step(step, eng.fold_step(step, y)), y)
                for y in (local(d[k]) for k in ("x0", "x1", "x2")))
        # the round model: one fold per grid dimension on a fresh engine
        for step in (XY_STEP, YZ_STEP):
            eng = comm.build_engine(EngineSpec(engine=name), grid)
            before = _wire_counts(ctx)
            eng.fold_step(step, local(d["x"]))
            after = _wire_counts(ctx)
            rounds[f"{name}/{step.name}"] = (eng.exchange_rounds, {
                k: (v[0] - before.get(k, (0, 0))[0], v[1] - before.get(k, (0, 0))[1])
                for k, v in after.items() if v != before.get(k, (0, 0))})
        for variant in VARIANTS:
            knobs = {"pipelined": dict(schedule="pipelined", chunks=2),
                     "real": dict(real=True)}.get(variant, {})
            fwd, inv, plan = make_fft3d(grid, N, device="cpu", spec=EngineSpec(
                engine=name, backend="pallas", **knobs))
            if plan.real:
                kr, ki = fwd(local(d["xr"]))
                back = (inv(kr, ki), torch.zeros(()))
            else:
                kr, ki = fwd(local(d["xr"]), local(d["xi"]))
                back = inv(kr, ki)
            arrays[f"{name}/{variant}"] = (gathered(kr), gathered(ki))
            arrays[f"{name}/{variant}/back"] = (gathered(back[0]),
                                                gathered(back[1].expand_as(back[0])))
        with obs.capture() as (_, met):
            fwd, _, _ = make_fft3d(grid, N, device="cpu", spec=EngineSpec(engine=name))
            fwd(local(d["xr"]), local(d["xi"]))
        metrics[name] = met.counters()

    # the fused schedules, the payload on its plain version
    wires = [w for dim in ("u", "v") for w in ctx.axis_wires(dim, "cpu")]
    for w in wires:
        w.fuses = True
    kern = DiagonalKernel(dr=local(d["dr"]), di=local(d["di"]))
    for name in FUSING:
        for fused_rt in (False, True):
            plain = ring_rdma.plain_calls
            _, _, plan = make_fft3d(grid, N, device="cpu", spec=EngineSpec(
                engine=name, backend="pallas", schedule="pipelined",
                chunks=2, fused_roundtrip=fused_rt))
            br, bi = spectral_roundtrip_local(plan, kern, local(d["xr"]),
                                              local(d["xi"]))
            arrays[f"{name}/fused/{fused_rt}"] = (gathered(br), gathered(bi))
            flags[f"{name}/fused/{fused_rt}/payloads"] = ring_rdma.plain_calls > plain
    for w in wires:
        w.fuses = False
    return {"arrays": arrays, "flags": flags, "rounds": rounds, "metrics": metrics,
            "staged_payload": _staged_payload(ctx, _inputs()),
            "labels": sorted(f"{k[0]}/{k[1]}" for k in ctx.groups)}


@pytest.fixture(scope="module")
def port_results(jax_results):
    """Every rank's results; the ranks run while the JAX child does."""
    del jax_results  # started first
    return dist.run_ranks(_port_side, PU, PV, u_sizes=U_SIZES, device="cpu")


def _close(got, want, tol=TOL):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_ranks_hold_a_group_per_mesh_axis_line(port_results):
    # every rank is in one line of each group: its grid dimensions' and,
    # for u over two axes, one per mesh axis
    for r in port_results:
        assert r["labels"] == ["u/data", "u/pod", "u/pod*data", "v/model"]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fold", ["xy", "yz"])
def test_relayout_matches_jax_bit_for_bit(jax_results, port_results, engine, fold):
    got = port_results[0]["arrays"][f"{engine}/fold_{fold}"]
    want = jax_results(f"fold_{fold}")
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_unfold_after_fold_is_identity(port_results, engine):
    for rank in port_results:
        for fold in ("xy", "yz"):
            assert rank["flags"][f"{engine}/identity_{fold}"], fold


@pytest.mark.parametrize("engine", ENGINES)
def test_one_staged_ring_per_mesh_axis(port_results, engine):
    model = _model(engine)
    # the ring engines count their rounds through their hooks; switched
    # and torus relayout without them, as in the reference
    hooks = engine in ("overlap_ring", "pallas_ring", "bidi_ring")
    for rank in port_results:
        engine_rounds, wires = rank["rounds"][f"{engine}/xy"]
        if engine == "switched":
            # one all-to-all over the pod*data product group, one round
            assert wires == {"u/pod*data": (1, 1)} and engine_rounds == 0
        else:
            # one ring per mesh axis, innermost first: 1 + 1 rounds, fewer
            # than one flat ring over the 4 ranks of u (3) for the ring
            assert wires == {"u/pod": (1, model(2)), "u/data": (1, model(2))}
            assert engine_rounds == (2 * model(2) if hooks else 0)
            assert 2 * model(2) == 2
        engine_rounds, wires = rank["rounds"][f"{engine}/yz"]
        assert wires == {"v/model": (1, model(2))}
        assert engine_rounds == (model(2) if hooks else 0)
    assert tr.ring_rounds(4) == 3 and tr.bidi_rounds(4) == 2


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_fft3d_matches_jax(jax_results, port_results, engine, variant):
    arrays = port_results[0]["arrays"]
    kr, ki = arrays[f"{engine}/{variant}"]
    _close(kr + 1j * ki, jax_results("real" if variant == "real" else "c2c"))
    br, bi = arrays[f"{engine}/{variant}/back"]
    d = _inputs()
    _close(br + 1j * bi, d["xr"] if variant == "real" else d["xr"] + 1j * d["xi"])


@pytest.mark.parametrize("engine", FUSING)
@pytest.mark.parametrize("fused_roundtrip", [False, True])
def test_fused_schedules_match_jax(jax_results, port_results, engine, fused_roundtrip):
    br, bi = port_results[0]["arrays"][f"{engine}/fused/{fused_roundtrip}"]
    _close(br + 1j * bi, jax_results("roundtrip"))
    assert all(r["flags"][f"{engine}/fused/{fused_roundtrip}/payloads"]
               for r in port_results)


@pytest.mark.parametrize("engine", FUSING)
def test_payload_rides_the_first_stage_only(port_results, engine):
    # the first stage (data, q=2) has one round: the whole payload in one
    # chunk, one call of the plain version; the pod stage carries none
    assert ring_rdma._chunk_bounds(37, 1, 0) == (0, 37)
    for r in port_results:
        calls, payload_ok, blocks_ok = r["staged_payload"][engine]
        assert calls == 1 and payload_ok and blocks_ok


@pytest.mark.parametrize("engine", ENGINES)
def test_wire_counters_follow_the_model(jax_results, port_results, engine):
    groups = ([("pod*data", 4), ("model", 2)] if engine == "switched"
              else [("pod", 2), ("data", 2), ("model", 2)])
    per_exchange = _model(engine)
    for r in port_results:
        met = r["metrics"][engine]
        for ax, q in groups:
            n_ex = met.get(f"comm.exchanges.{ax}", 0)
            assert n_ex > 0, (ax, met)
            assert met[f"comm.exchange_rounds.{ax}"] == n_ex * per_exchange(q), (ax, met)
        assert met["comm.wire_bytes"] > 0
        if engine == "switched":
            assert met["comm.all_to_all_dispatches"] > 0
        labels = {k.split(".", 2)[2] for k in met if k.startswith("comm.exchanges.")}
        assert labels == {ax for ax, _ in groups}
    # one transform counts what JAX's trace of one transform counts
    want = json.loads(str(jax_results(f"metrics/{engine}")))
    got = dict(port_results[0]["metrics"][engine])
    want = {k: v for k, v in want.items() if k.startswith("comm.")}
    if engine == "bidi_ring":
        assert got.pop("comm.rdma_dispatches") > 0
        assert want.pop("comm.ppermute_dispatches") > 0
    assert got == want


if __name__ == "__main__":
    _jax_side(sys.argv[1])
