"""Port parity of the multi-rank exchanges: the five engines' relayouts,
the 3D FFT and the fused payload schedules on 2×2, 4×1, 3×1 (odd P for the
bidirectional ring) and 1×4 grids, against the JAX package on the same
meshes.

The port runs its ranks as gloo processes on the CPU
(:func:`repro_torch.dist.run_ranks`, spawned once per mesh); the JAX side
runs in a child process with fake host devices (this file run as a
script) and hands its results over as ``.npz``.  Inputs come from numpy
with a seed, the same on both sides.  Tolerances:

* relayouts bit for bit against JAX's ``switched`` fold (the JAX package's
  own ``tests/_dist_transpose_check.py`` pins every JAX engine's relayout
  bit-identical to it), and ``unfold ∘ fold`` the identity bit for bit;
* 3D FFTs within 1e-10 of the largest entry (the reference's f64 bound);
* the fused schedules, run with the payload's plain version on the gloo
  wire, within 1e-10 of JAX's unfused ``pallas_ring`` on the same mesh
  (JAX fuses only on a TPU);
* ``payload_plain`` within 1e-13 of the largest entry of a JAX mirror of
  ``_payload_chunk`` built from ``butterfly_stages`` (same stage order;
  the two frameworks may contract or round a product differently).
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch import dist
from repro_torch.core import comm
from repro_torch.core import transpose as tr
from repro_torch.core.decomposition import XY_STEP, YZ_STEP
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.core.fft3d import (DiagonalKernel, gather_pencil, make_fft3d,
                                    scatter_pencil, spectral_roundtrip_local)
from repro_torch.kernels import fft_radix2, ring_rdma

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((2, 2), (4, 1), (3, 1), (1, 4))
ENGINES = ("switched", "torus", "overlap_ring", "pallas_ring", "bidi_ring")
FUSING = ("pallas_ring", "bidi_ring")
VARIANTS = ("c2c", "pipelined", "real")
PAYLOAD_N = (8, 64)
TOL = 1e-10


def _n(pu, pv):
    """Extent (nx, ny, nz): N=8, or 12 along x and y where a 3-rank
    dimension needs it (no radix-2 kernel there)."""
    return (12, 12, 8) if 3 in (pu, pv) else (8, 8, 8)


def _backend(pu, pv):
    return "jnp" if 3 in (pu, pv) else "pallas"


def _inputs(pu, pv):
    """X-pencil inputs ``(Ny, Nz, Nx)``, three more for the identity
    check, and a Z-pencil multiplier ``(Nx, Ny, Nz)``."""
    nx, ny, nz = _n(pu, pv)
    rng = np.random.default_rng(10 * pu + pv)
    d = {k: rng.standard_normal((ny, nz, nx)) for k in ("x", "xr", "xi", "x0", "x1", "x2")}
    d["dr"], d["di"] = (rng.standard_normal((nx, ny, nz)) for _ in range(2))
    return d


def _payload_inputs(n):
    rng = np.random.default_rng(n)
    return [rng.standard_normal((5, n)) for _ in range(4)]


# ---------------------------------------------------------------------------
# the JAX side (run as a script, in a child process with fake devices)
# ---------------------------------------------------------------------------

def _jax_side(out: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro import compat
    from repro.core import comm as jcomm
    from repro.core.decomposition import PencilGrid
    from repro.core.engine_spec import EngineSpec as JSpec
    from repro.core.fft3d import make_fft3d as jmake_fft3d
    from repro.kernels.fft_radix2 import butterfly_stages
    from repro.kernels.ref import twiddle_table_np

    res = {}
    for pu, pv in MESHES:
        tag = f"{pu}x{pv}"
        mesh = compat.make_mesh((pu, pv), ("data", "model"),
                                devices=jax.devices()[:pu * pv])
        grid = PencilGrid.from_mesh(mesh, ("data",), ("model",))
        spec = grid.pencil_spec()
        d = _inputs(pu, pv)
        n = _n(pu, pv)
        eng = jcomm.build_engine(JSpec(engine="switched"), grid)
        for which in ("xy", "yz"):
            f = jax.jit(compat.shard_map(
                lambda a, w=which: eng.fold(w, a), mesh=mesh, in_specs=(spec,),
                out_specs=spec, check_vma=False))
            res[f"{tag}/fold_{which}"] = np.asarray(f(d["x"]))
        fwd, inv, _ = jmake_fft3d(mesh, n, spec=JSpec(engine="switched"))
        kr, ki = fwd(d["xr"], d["xi"])
        res[f"{tag}/c2c"] = np.asarray(kr) + 1j * np.asarray(ki)
        fwd, inv, _ = jmake_fft3d(mesh, n, spec=JSpec(engine="switched", real=True))
        kr, ki = fwd(d["xr"])
        res[f"{tag}/real"] = np.asarray(kr) + 1j * np.asarray(ki)
        if _backend(pu, pv) != "pallas":  # no fused schedule to hold
            continue
        # the composed roundtrip on JAX's (unfused) pallas_ring
        fwd, inv, _ = jmake_fft3d(mesh, n, spec=JSpec(engine="pallas_ring"))
        kr, ki = fwd(d["xr"], d["xi"])
        dr, di = d["dr"], d["di"]
        br, bi = inv(kr * dr - ki * di, kr * di + ki * dr)
        res[f"{tag}/roundtrip"] = np.asarray(br) + 1j * np.asarray(bi)

    for n in PAYLOAD_N:
        pr, pi, dr, di = (jnp.asarray(a) for a in _payload_inputs(n))
        twr, twi = (jnp.asarray(t) for t in twiddle_table_np(n, "float64"))
        scale = jnp.asarray(1.0 / n, pr.dtype)
        for mode in ("forward", "inverse", "roundtrip"):
            # _payload_chunk (ring_rdma.py:153), mode by mode
            ci = -pi if mode == "inverse" else pi
            yr, yi = butterfly_stages(pr, ci, twr, twi, n)
            if mode == "inverse":
                yr, yi = yr * scale, -(yi * scale)
            if mode == "roundtrip":
                kr = yr * dr - yi * di
                ki = yr * di + yi * dr
                zr, zi = butterfly_stages(kr, -ki, twr, twi, n)
                yr, yi = zr * scale, -(zi * scale)
            res[f"payload/{n}/{mode}"] = np.asarray(yr) + 1j * np.asarray(yi)
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

def _model(name):
    """Wire rounds per exchange of an engine's transport."""
    return {"switched": lambda p: 1, "bidi_ring": tr.bidi_rounds}.get(
        name, tr.ring_rounds)


def _port_side(ctx):
    grid = ctx.grid()
    pu, pv = ctx.pu, ctx.pv
    n, bk = _n(pu, pv), _backend(pu, pv)
    d = {k: torch.from_numpy(v) for k, v in _inputs(pu, pv).items()}

    def local(a):
        return scatter_pencil(a, grid).contiguous()

    def gathered(t):
        g = gather_pencil(t, grid)
        return None if g is None else g.numpy()

    arrays, flags, rounds = {}, {}, {}
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
            wire = ctx.wire(step.grid_dim, "cpu")
            before = (wire.exchanges, wire.rounds) if wire else (0, 0)
            eng.fold_step(step, local(d["x"]))
            after = (wire.exchanges, wire.rounds) if wire else (0, 0)
            rounds[f"{name}/{step.name}"] = (
                grid.dim_ranks(step.grid_dim), eng.exchange_rounds,
                after[0] - before[0], after[1] - before[1])
        for variant in VARIANTS:
            knobs = {"pipelined": dict(schedule="pipelined", chunks=2),
                     "real": dict(real=True)}.get(variant, {})
            fwd, inv, plan = make_fft3d(grid, n, device="cpu", spec=EngineSpec(
                engine=name, backend=bk, **knobs))
            if plan.real:
                kr, ki = fwd(local(d["xr"]))
                back = (inv(kr, ki), torch.zeros(()))
            else:
                kr, ki = fwd(local(d["xr"]), local(d["xi"]))
                back = inv(kr, ki)
            arrays[f"{name}/{variant}"] = (gathered(kr), gathered(ki))
            arrays[f"{name}/{variant}/back"] = (gathered(back[0]),
                                                gathered(back[1].expand_as(back[0])))

    if bk == "pallas":  # the fused schedules, the payload on its plain version
        wires = [w for w in (ctx.wire("u", "cpu"), ctx.wire("v", "cpu")) if w]
        for w in wires:
            w.fuses = True
        kern = DiagonalKernel(dr=local(d["dr"]), di=local(d["di"]))
        for name in FUSING:
            for fused_rt in (False, True):
                plain = ring_rdma.plain_calls
                _, _, plan = make_fft3d(grid, n, device="cpu", spec=EngineSpec(
                    engine=name, backend="pallas", schedule="pipelined",
                    chunks=2, fused_roundtrip=fused_rt))
                br, bi = spectral_roundtrip_local(plan, kern, local(d["xr"]),
                                                  local(d["xi"]))
                arrays[f"{name}/fused/{fused_rt}"] = (gathered(br), gathered(bi))
                flags[f"{name}/fused/{fused_rt}/payloads"] = ring_rdma.plain_calls > plain
        for w in wires:
            w.fuses = False
    return {"arrays": arrays, "flags": flags, "rounds": rounds}


@pytest.fixture(scope="module")
def port_results(jax_results):
    """Per mesh, every rank's results; all meshes run while the JAX child
    does."""
    del jax_results  # started first
    results = {mesh: dist.run_ranks(_port_side, *mesh, device="cpu")
               for mesh in MESHES}
    return results.__getitem__


def _close(got, want, tol=TOL):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fold", ["xy", "yz"])
def test_relayout_matches_jax_bit_for_bit(jax_results, port_results, mesh,
                                          engine, fold):
    got = port_results(mesh)[0]["arrays"][f"{engine}/fold_{fold}"]
    want = jax_results(f"{_tag(mesh)}/fold_{fold}")
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
@pytest.mark.parametrize("engine", ENGINES)
def test_unfold_after_fold_is_identity(port_results, mesh, engine):
    for rank in port_results(mesh):
        for fold in ("xy", "yz"):
            assert rank["flags"][f"{engine}/identity_{fold}"], (rank, fold)


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
@pytest.mark.parametrize("engine", ENGINES)
def test_exchange_rounds_follow_the_model(port_results, mesh, engine):
    hooks = engine in ("overlap_ring", "pallas_ring", "bidi_ring")
    for rank in port_results(mesh):
        for fold in ("xy", "yz"):
            p, engine_rounds, exchanges, wire_rounds = rank["rounds"][f"{engine}/{fold}"]
            if p == 1:  # a local permute: nothing on a wire
                assert (engine_rounds, exchanges, wire_rounds) == (0, 0, 0)
                continue
            assert exchanges == 1
            assert wire_rounds == _model(engine)(p)
            # the ring engines count their rounds through their hooks
            assert engine_rounds == (wire_rounds if hooks else 0)
    if engine == "bidi_ring" and mesh == (4, 1):
        assert tr.bidi_rounds(4) == 2 and tr.bidi_schedule(4) == [[1, -1], [2]]


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_fft3d_matches_jax(jax_results, port_results, mesh, engine, variant):
    arrays = port_results(mesh)[0]["arrays"]
    kr, ki = arrays[f"{engine}/{variant}"]
    want = jax_results(f"{_tag(mesh)}/{'real' if variant == 'real' else 'c2c'}")
    _close(kr + 1j * ki, want)
    br, bi = arrays[f"{engine}/{variant}/back"]
    d = _inputs(*mesh)
    x = d["xr"] if variant == "real" else d["xr"] + 1j * d["xi"]
    _close(br + 1j * bi, x)


@pytest.mark.parametrize("mesh", [m for m in MESHES if _backend(*m) == "pallas"],
                         ids=_tag)
@pytest.mark.parametrize("engine", FUSING)
@pytest.mark.parametrize("fused_roundtrip", [False, True])
def test_fused_schedules_match_jax(jax_results, port_results, mesh, engine,
                                   fused_roundtrip):
    ranks = port_results(mesh)
    br, bi = ranks[0]["arrays"][f"{engine}/fused/{fused_roundtrip}"]
    _close(br + 1j * bi, jax_results(f"{_tag(mesh)}/roundtrip"))
    assert all(r["flags"][f"{engine}/fused/{fused_roundtrip}/payloads"]
               for r in ranks)


@pytest.mark.parametrize("n", PAYLOAD_N)
@pytest.mark.parametrize("mode", ["forward", "inverse", "roundtrip"])
def test_payload_plain_matches_jax_mirror(jax_results, n, mode):
    pr, pi, dr, di = (torch.from_numpy(a) for a in _payload_inputs(n))
    twr, twi = fft_radix2.twiddles(n, torch.float64, torch.device("cpu"))
    diag = (dr, di) if mode == "roundtrip" else None
    calls = ring_rdma.plain_calls
    yr, yi = ring_rdma.payload_plain(pr, pi, twr, twi, diag, mode == "inverse")
    assert ring_rdma.plain_calls == calls + 1
    _close((yr + 1j * yi).numpy(), jax_results(f"payload/{n}/{mode}"), tol=1e-13)
    # the wrapper runs the plain version for CPU tensors, and never launches
    launches = ring_rdma.payload_launches
    wr, wi = ring_rdma.ring_payload(pr, pi, diag=diag, inverse=mode == "inverse")
    assert torch.equal(wr, yr) and torch.equal(wi, yi)
    assert ring_rdma.payload_launches == launches


def test_chunk_bounds_cover_the_rows():
    for total, parts in ((129, 3), (10, 4), (3, 5), (0, 2)):
        spans = [ring_rdma._chunk_bounds(total, parts, i) for i in range(parts)]
        assert sum(c for _, c in spans) == total
        assert all(o + c == spans[i + 1][0] for i, (o, c) in enumerate(spans[:-1]))


if __name__ == "__main__":
    _jax_side(sys.argv[1])
