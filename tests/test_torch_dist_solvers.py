"""Port parity of the four solver cases on 2×2 and 4×1 grids, against the
JAX package's solvers on the same meshes, f64, N=8.

The port's ranks are gloo processes on the CPU (:func:`repro_torch.dist.
run_ranks`, spawned once per mesh), each case run on four plans: the
solvers' default (pipelined, switched, ``torch.fft``), ``overlap_ring``,
``pallas_ring`` with the fused roundtrip and ``bidi_ring``, the last two on
the radix-2 backend with the payload fused on the gloo wire (its plain
version) and three slabs.  The JAX side runs its default plan in a child process with fake
host devices (this file run as a script).  Tolerance: per-step observables
within 1e-10 (``observables_rel_err``) and final fields within 1e-10 of
their largest entry, the reference's own f64 bounds.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import dist
from repro_torch.core.decomposition import PencilGrid
from repro_torch.core.fft3d import gather_pencil, scatter_pencil
from repro_torch.kernels import ring_rdma
from repro_torch.solvers import cli, make_solver
from repro_torch.solvers.base import observables_rel_err

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((2, 2), (4, 1))
CASES = ("poisson", "heat", "navier_stokes", "nls")
N, STEPS = 8, 2
PLANS = {
    "default": {},
    "overlap_ring": {"comm_engine": "overlap_ring", "backend": "pallas"},
    # chunks=3: the real cases' Y-pencil slab axis holds kx/Pu = 3 rows on
    # 2x2, one slab (no payload) at chunks=2
    "pallas_ring_fused": {"comm_engine": "pallas_ring", "backend": "pallas",
                          "fused_roundtrip": True, "chunks": 3},
    "bidi_ring": {"comm_engine": "bidi_ring", "backend": "pallas", "chunks": 3},
}


def _tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _jax_side(out: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_enable_x64", True)

    from repro import compat
    from repro.solvers import make_solver as jmake_solver

    res = {}
    for mesh_shape in MESHES:
        mesh = compat.make_mesh(mesh_shape, ("data", "model"))
        for case in CASES:
            state, hist = jmake_solver(case, mesh, N).run(STEPS)
            key = f"{_tag(mesh_shape)}/{case}"
            for name in hist[0]:
                res[f"{key}/obs/{name}"] = np.array([h[name] for h in hist])
            for i, f in enumerate(state.fields):
                res[f"{key}/field/{i}"] = np.asarray(f)
    np.savez(out, **res)


@pytest.fixture(scope="module")
def jax_results():
    """``(histories, arrays)`` of the JAX side, computed in a child process
    that starts with the module and runs while the port's ranks do (read
    on first use)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "jax.npz")
        child = subprocess.Popen([sys.executable, os.path.abspath(__file__), out],
                                 env=env, stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE, text=True)
        loaded = []

        def get():
            if not loaded:
                _, err = child.communicate(timeout=600)
                assert child.returncode == 0, err[-3000:]
                with np.load(out) as z:
                    res = dict(z)
                hists = {}
                for k, v in res.items():
                    if "/obs/" in k:
                        key, name = k.split("/obs/")
                        hists.setdefault(key, [dict() for _ in v])
                        for h, x in zip(hists[key], v):
                            h[name] = float(x)
                loaded.append((hists, res))
            return loaded[0]
        yield get
        child.kill()
        child.communicate()


def _port_side(ctx):
    grid = ctx.grid()
    for dim in ("u", "v"):
        wire = ctx.wire(dim, "cpu")
        if wire is not None:
            wire.fuses = True
    out = {}
    for case in CASES:
        # the t=0 fields: this rank's block of the 1x1 solver's
        whole = make_solver(case, PencilGrid.from_mesh(1, 1), N, device="cpu")
        mine = make_solver(case, grid, N, device="cpu")
        out[f"{case}/init_blocks"] = all(
            torch.equal(scatter_pencil(w, grid), m)
            for w, m in zip(whole.initial_fields(), mine.initial_fields())
        ) if case != "navier_stokes" else None
        for plan, cfg in PLANS.items():
            plain = ring_rdma.plain_calls
            state, hist = make_solver(case, grid, N, device="cpu",
                                      plan_cfg=cfg or None).run(STEPS)
            fields = [gather_pencil(f, grid) for f in state.fields]
            out[f"{case}/{plan}"] = (
                hist, None if fields[0] is None else [f.numpy() for f in fields],
                ring_rdma.plain_calls - plain)
    return out


@pytest.fixture(scope="module")
def port_results(jax_results):
    """Per mesh, every rank's results; all meshes run while the JAX child
    does."""
    del jax_results  # started first
    results = {mesh: dist.run_ranks(_port_side, *mesh, device="cpu")
               for mesh in MESHES}
    return results.__getitem__


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("plan", PLANS)
def test_case_matches_jax_on_the_mesh(jax_results, port_results, mesh, case,
                                      plan):
    key = f"{_tag(mesh)}/{case}"
    ranks = port_results(mesh)
    hists, arrays = jax_results()
    hist, fields, payloads = ranks[0][f"{case}/{plan}"]
    for got, want in zip(hist, hists[key]):
        assert observables_rel_err(got, want) <= 1e-10, (got, want)
    for i, f in enumerate(fields):
        want = arrays[f"{key}/field/{i}"]
        assert f.shape == want.shape
        assert np.abs(f - want).max() <= 1e-10 * max(np.abs(want).max(), 1e-300)
    # every rank reports the same observables
    for r in ranks[1:]:
        assert r[f"{case}/{plan}"][0] == hist
    # the fused plans ran payloads (on the plain version, here): on every
    # c2c fold over more than one rank -- the Y<->Z fold on 2x2, only nls'
    # X<->Y fold on 4x1
    fused = plan in ("pallas_ring_fused", "bidi_ring") and (
        mesh[1] > 1 or case == "nls")
    assert all((r[f"{case}/{plan}"][2] > 0) == fused for r in ranks)


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_initial_fields_are_blocks_of_the_single_rank_fields(port_results, mesh):
    for r in port_results(mesh):
        for case in CASES:
            assert r[f"{case}/init_blocks"] in (True, None)


def test_cli_runs_a_mesh_of_ranks(capfd):
    assert cli.main(["--case", "heat", "--n", "8", "--steps", "1",
                     "--mesh", "2x2", "--comm-engine", "pallas_ring",
                     "--device", "cpu", "--quiet"]) == 0
    out = capfd.readouterr().out
    assert "mesh=2x2" in out and out.count("heat: OK") == 1
    assert cli.main(["--case", "heat", "--n", "8", "--mesh", "3x1",
                     "--device", "cpu"]) == 1
    assert "invalid problem for mesh 3x1" in capfd.readouterr().err


if __name__ == "__main__":
    _jax_side(sys.argv[1])
