"""``repro_torch.checkpoint`` against ``repro.checkpoint``.

* ``tests/test_checkpoint.py``'s eight tests on torch tensors: atomic
  visibility, keep-last-k GC, the torn-``LATEST`` scan, the async writer's
  error capture, the counters (the torn writes come from the fleet's
  fault injector, :func:`repro.fleet.faults.arm_torn_checkpoint`);
* the host snapshot is a copy: a tensor changed in place after ``save``
  does not change what lands;
* the flat keys are those of ``jax.tree_util.tree_flatten_with_path``;
* across packages, heat at N=16 on one rank: a checkpoint the JAX
  package's ``CheckpointManager`` writes from a JAX solver's
  ``state_tree`` restores in the port and continues on JAX's trajectory,
  and the reverse; per-step observables within 1e-10
  (``observables_rel_err``), final fields within 1e-10 of their largest
  entry;
* 4 gloo ranks (``tests/_dist_solver_check.py:114–131``): heat N=8 saved
  on 2×2 at step 2, restored on 2×2 bitwise, on 4×1 and 1×4 within 1e-10
  by ``observables_rel_err`` of the uninterrupted run (``mean`` is
  roundoff there, and a pure relative bound cannot hold on it: ROADMAP
  "Reference health").
"""

import os
import tempfile
import threading

import numpy as np
import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

import jax

from repro import compat
from repro.checkpoint.checkpoint import CheckpointManager as JManager
from repro.fleet.faults import arm_torn_checkpoint
from repro.solvers import make_solver as jmake_solver
from repro_torch import dist, obs
from repro_torch.checkpoint import CheckpointError, CheckpointManager
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.core.decomposition import PencilGrid
from repro_torch.core.fft3d import gather_pencil
from repro_torch.solvers import make_solver
from repro_torch.solvers.base import observables_rel_err


@pytest.fixture(autouse=True)
def _obs_reset():
    obs.disable()
    obs.clear()
    yield
    obs.disable()
    obs.clear()


def _tree(v: float = 0.0):
    return {"fields": [torch.full((4, 4), v, dtype=torch.float64),
                       torch.arange(8.0, dtype=torch.float64) + v],
            "t": np.float64(v), "n_steps": np.int64(int(v))}


def _assert_tree_equal(a, b):
    assert torch.equal(a["fields"][0], b["fields"][0])
    assert torch.equal(a["fields"][1], b["fields"][1])
    assert a["t"] == b["t"] and a["n_steps"] == b["n_steps"]


# ---------------------------------------------------------------------------
# roundtrip + GC + pointer fallback
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    assert mgr.latest_step() is None
    mgr.save(2, _tree(2.0), meta={"case": "heat"}, block=True)
    assert mgr.latest_step() == 2
    assert mgr.last_save_bytes > 0
    tree, meta = mgr.restore(_tree(0.0))
    _assert_tree_equal(tree, _tree(2.0))
    assert meta["case"] == "heat" and meta["step"] == 2


def test_keep_last_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _tree(float(step)), block=True)
    kept = sorted(d for d in os.listdir(mgr.dir) if d.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]
    assert mgr.latest_step() == 4
    # an old step is gone for good, not just unlisted
    with pytest.raises((KeyError, OSError, AssertionError)):
        mgr.restore(_tree(0.0), step=1)


def test_latest_step_scan_fallback_on_torn_pointer(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    mgr.save(1, _tree(1.0), block=True)
    mgr.save(2, _tree(2.0), block=True)
    ptr = os.path.join(mgr.dir, "LATEST")
    # pointer at a directory that was never completed
    with open(ptr, "w") as f:
        f.write("step_00000099")
    assert mgr.latest_step() == 2
    tree, _ = mgr.restore(_tree(0.0))
    _assert_tree_equal(tree, _tree(2.0))
    # no pointer at all: same scan
    os.remove(ptr)
    assert mgr.latest_step() == 2


# ---------------------------------------------------------------------------
# the async writer's error capture
# ---------------------------------------------------------------------------

def test_async_write_error_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    mgr.save(2, _tree(2.0), block=True)
    arm_torn_checkpoint(mgr, at_step=4)
    mgr.save(4, _tree(4.0))            # async: returns without raising
    with pytest.raises(CheckpointError, match="injected torn checkpoint"):
        mgr.wait()
    # the torn tmp is invisible; the last complete snapshot still resolves
    assert mgr.latest_step() == 2
    tree, _ = mgr.restore(_tree(0.0))
    _assert_tree_equal(tree, _tree(2.0))
    # the error was consumed — the manager recovers, next save lands
    mgr.save(6, _tree(6.0), block=True)
    assert mgr.latest_step() == 6


def test_async_write_error_surfaces_on_next_save(tmp_path):
    # the implicit wait() at the head of save() re-raises too: a failed
    # async write can never masquerade as success across saves
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    arm_torn_checkpoint(mgr, at_step=0)
    mgr.save(2, _tree(2.0))
    with pytest.raises(CheckpointError, match="OSError"):
        mgr.save(4, _tree(4.0))
    mgr.save(6, _tree(6.0), block=True)   # fault fired once; recovered
    assert mgr.latest_step() == 6


def test_blocking_save_raises_inline(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    arm_torn_checkpoint(mgr, at_step=0)
    with pytest.raises(CheckpointError, match="injected torn checkpoint"):
        mgr.save(2, _tree(2.0), block=True)
    assert mgr.latest_step() is None


def test_sync_mode_raises_inline(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3, async_write=False)
    arm_torn_checkpoint(mgr, at_step=0)
    with pytest.raises(CheckpointError, match="injected torn checkpoint"):
        mgr.save(2, _tree(2.0))
    mgr.save(4, _tree(4.0))
    assert mgr.latest_step() == 4


def test_checkpoint_metrics(tmp_path):
    with obs.capture() as (_, metrics):
        mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
        mgr.save(2, _tree(2.0), block=True)
        arm_torn_checkpoint(mgr, at_step=4)
        with pytest.raises(CheckpointError):
            mgr.save(4, _tree(4.0), block=True)
        mgr.restore(_tree(0.0))
    c = metrics.counters()
    assert c["checkpoint.saves"] == 2
    assert c["checkpoint.write_errors"] == 1
    assert c["checkpoint.restores"] == 1
    assert c["checkpoint.bytes"] == 2 * mgr.last_save_bytes
    assert metrics.gauges()["checkpoint.restore_us"] > 0


def test_checkpoint_save_gauges_time_the_latest_save(tmp_path):
    with obs.capture() as (_, metrics):
        mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
        mgr.save(2, _tree(2.0), block=True)
    g = metrics.gauges()
    assert g["checkpoint.snapshot_us"] == mgr.last_snapshot_s * 1e6
    assert g["checkpoint.write_us"] == mgr.last_write_s * 1e6 > 0


# ---------------------------------------------------------------------------
# the port's own: the snapshot, the keys, the placement
# ---------------------------------------------------------------------------

def test_snapshot_is_a_copy(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    tree = _tree(2.0)
    gate = threading.Event()
    orig = mgr._write

    def gated_write(step, host, meta):  # the writer runs after the mutation
        assert gate.wait(timeout=60)
        return orig(step, host, meta)
    mgr._write = gated_write
    mgr.save(2, tree)
    tree["fields"][0].add_(100.0)      # a later step, in place
    tree["fields"][1].zero_()
    gate.set()
    mgr.wait()
    got, _ = mgr.restore(_tree(0.0))
    _assert_tree_equal(got, _tree(2.0))
    assert mgr.last_snapshot_s >= 0 and mgr.last_write_s > 0


def test_flat_keys_are_the_references():
    tree = {"fields": (np.zeros(2), [np.ones(1), {"b": 1.0, "a": 2.0}]),
            "t": np.float64(0.5), "none": None, "n_steps": np.int64(3)}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = ["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            for path, _ in flat]
    assert list(_flatten(tree)) == want
    assert want == ["fields/0", "fields/1/0", "fields/1/1/a", "fields/1/1/b",
                    "n_steps", "t"]


def test_restore_checks_shapes_and_places_leaves(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    mgr.save(1, _tree(1.0), block=True)
    target = {"fields": [torch.empty(4, 4, dtype=torch.float32, device="meta"),
                         torch.empty(8, dtype=torch.float64, device="meta")],
              "t": np.float64(0), "n_steps": np.int64(0)}
    tree, _ = mgr.restore(target, place={"fields": [lambda a: torch.from_numpy(a[:2])]})
    assert tree["fields"][0].dtype == torch.float32 and tree["fields"][0].shape == (2, 4)
    assert torch.equal(tree["fields"][1], _tree(1.0)["fields"][1])
    target["fields"][1] = torch.empty(9, device="meta")
    with pytest.raises(ValueError, match="fields/1"):
        mgr.restore(target)


# ---------------------------------------------------------------------------
# across packages, heat N=16 on one rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh11():
    return compat.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])


def _continue(solver, state, steps=2):
    hist = []
    for _ in range(steps):
        state = solver.step(state)
        hist.append(solver.observables(state))
    return state, hist


def _close(got, want, tol=1e-10):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_a_jax_checkpoint_restores_in_the_port(mesh11, tmp_path):
    js = jmake_solver("heat", mesh11, 16)
    st, _ = _continue(js, js.init_state())
    JManager(str(tmp_path), keep=2).save(2, js.state_tree(st), meta={"by": "jax"},
                                         block=True)
    jst, jhist = _continue(js, st)

    ps = make_solver("heat", PencilGrid.from_mesh(1, 1), 16, device="cpu")
    pst, meta = ps.restore_state(CheckpointManager(str(tmp_path)))
    assert meta["by"] == "jax" and pst.n_steps == 2 and pst.t == st.t
    pst, phist = _continue(ps, pst)
    for a, b in zip(phist, jhist):
        assert observables_rel_err(a, b) <= 1e-10, (a, b)
    _close(pst.fields[0].numpy(), np.asarray(jst.fields[0]))


def test_a_port_checkpoint_restores_in_jax(mesh11, tmp_path):
    ps = make_solver("heat", PencilGrid.from_mesh(1, 1), 16, device="cpu")
    st, _ = _continue(ps, ps.init_state())
    CheckpointManager(str(tmp_path), keep=2).save(2, ps.state_tree(st),
                                                  meta={"by": "port"}, block=True)
    pst, phist = _continue(ps, st)

    js = jmake_solver("heat", mesh11, 16)
    jst, meta = js.restore_state(JManager(str(tmp_path)))
    assert meta["by"] == "port" and jst.n_steps == 2 and jst.t == st.t
    jst, jhist = _continue(js, jst)
    for a, b in zip(phist, jhist):
        assert observables_rel_err(a, b) <= 1e-10, (a, b)
    _close(np.asarray(jst.fields[0]), pst.fields[0].numpy())


# ---------------------------------------------------------------------------
# 4 gloo ranks: save on 2x2, restore on 2x2, 4x1 and 1x4
# ---------------------------------------------------------------------------

RESTORE_GRIDS = ((2, 2), (4, 1), (1, 4))


def _restores(ctx, directory):
    from torch import distributed as tdist

    solver = make_solver("heat", ctx.grid(), 8, device="cpu")
    mgr = CheckpointManager(directory, keep=2)
    st, ref = solver.init_state(), []
    for i in range(1, 5):
        st = solver.step(st)
        ref.append(solver.observables(st))
        if i == 2:
            tree = solver.state_tree(st)
            assert (tree is None) == (ctx.rank != 0)
            if tree is not None:
                mgr.save(i, tree, meta={"mesh": [ctx.pu, ctx.pv]}, block=True)
            tdist.barrier()
    want = gather_pencil(st.fields[0], ctx.grid())
    out = {"ref": ref[2:]}
    for grid in RESTORE_GRIDS:
        c = dist.regrid(*grid)
        s2 = make_solver("heat", c.grid(), 8, device="cpu")
        st2, meta = s2.restore_state(mgr)
        st2, hist = _continue(s2, st2)
        got = gather_pencil(st2.fields[0], c.grid())
        out[grid] = {"n_steps": st2.n_steps, "meta": meta["mesh"], "hist": hist,
                     "field": None if got is None else (got.numpy(), want.numpy())}
    return out


@pytest.fixture(scope="module")
def restored():
    with tempfile.TemporaryDirectory() as tmp:
        yield dist.run_ranks(_restores, 2, 2, device="cpu",
                             args=(os.path.join(tmp, "ck"),))


@pytest.mark.parametrize("grid", RESTORE_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_restore_onto_another_grid_continues_the_run(restored, grid):
    for r in restored:
        got = r[grid]
        assert got["n_steps"] == 4 and got["meta"] == [2, 2]
        for a, b in zip(got["hist"], r["ref"]):
            if grid == (2, 2):
                assert a == b  # bitwise on the grid it was saved from
            else:
                assert observables_rel_err(a, b) <= 1e-10, (a, b)
    field, want = restored[0][grid]["field"]
    if grid == (2, 2):
        assert np.array_equal(field, want)
    else:
        _close(field, want)
