"""The port's plan autotuner (``repro_torch.tuning``) against the reference's.

The candidate space equals ``repro.tuning.space``'s under one installed
calibration; the plan-cache fingerprint has the reference's key shape and
names torch, CUDA and the device in place of JAX; the cache round-trips;
``autotune`` and ``autotune_solver_step`` pick a winner no slower than the
default on 1×1 and replay it from the cache without timing anything.  On a
2×1 grid of rank processes every rank takes the same winner, and a
candidate refused on one rank is dropped on both without a deadlock.  Only
the validity refusals (``ValueError``, ``NotImplementedError``) drop a
candidate: a CUDA error propagates.
"""

import json
import os
import re
import sys

import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.core import perfmodel as jpm
from repro.tuning.cache import problem_fingerprint as jfingerprint
from repro.tuning.space import candidate_space as jcandidate_space
from repro_torch import dist, obs
from repro_torch.core import perfmodel as pm
from repro_torch.core.decomposition import PencilGrid
from repro_torch.core.fft3d import make_fft3d
from repro_torch.tuning import (DEFAULT_CANDIDATE, PlanCache, autotune,
                                autotune_solver_step, candidate_space,
                                default_cache_path, problem_fingerprint)
from repro_torch.tuning import cli as tcli
from repro_torch.tuning.autotune import speedup_vs_default
from repro_torch.tuning.cache import SCHEMA, substrate

TUNE = sys.modules["repro_torch.tuning.autotune"]
STEP = sys.modules["repro_torch.tuning.solver"]
SUBSTRATE_KEYS = {"torch_version", "cuda_version", "device_type",
                  "device_name", "device_count"}
CALIBRATION = {
    "engine_message_overhead_s": {"switched": 3.1e-5, "torus": 4.7e-5,
                                  "overlap_ring": 2.9e-5,
                                  "pallas_ring": 1.3e-5, "bidi_ring": 1.1e-5},
    "backend_compute_weight": {"jnp": 1.0, "ref": 37.5, "pallas": 1.21,
                               "mxu": 0.93},
    "link_bytes_per_s": 3.3e11,
}


@pytest.fixture(autouse=True)
def _priors():
    # the port's model on its priors, whatever calibration HOME holds
    pm.set_calibration(None)
    yield
    pm.set_calibration(None)


def _one():
    return PencilGrid.from_mesh(1, 1)


# ---------------------------------------------------------------------------
# space, fingerprint, cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,pu,pv,kw", [
    (8, 1, 1, {}),
    (64, 4, 2, {}),
    (256, 8, 8, {}),
    (24, 2, 2, {}),                                   # not a power of two
    (16, 2, 2, {"real": True}),                       # packed r2c
    (16, 4, 1, {"components": 3}),                    # vector modes
    (32, 2, 4, {"real": True, "fused": True}),        # solver-step space
    ((16, 32, 64), 2, 2, {"backends": ["jnp", "mxu"]}),
    (64, 4, 2, {"pu_axes": (2, 2), "pv_axes": (2,)}),  # staged u
])
def test_candidate_space_equals_the_reference(n, pu, pv, kw):
    pm.set_calibration(CALIBRATION)
    jpm.set_calibration(CALIBRATION)
    got = candidate_space(n, pu, pv, **kw)
    want = jcandidate_space(n, pu, pv, **kw)
    assert [c.name for c in got] == [c.name for c in want]
    assert [c.config() for c in got] == [c.config() for c in want]
    assert [c.spec(real=True) == c.from_spec(c.spec()).spec(real=True)
            for c in got] == [True] * len(got)


def test_fingerprint_key_shape_and_substrate(monkeypatch):
    kw = dict(real=True, components=0, dtype="float64", case="heat",
              solver_params={"dt": 0.01})
    key, payload = problem_fingerprint(16, 2, 2, device="cpu", **kw)
    jkey, jpayload = jfingerprint(16, 2, 2, **kw)
    # the reference's key, its digest aside
    assert re.fullmatch(r"solver_heat_n16x16x16_p2x2_r2c_float64_[0-9a-f]{16}", key)
    assert key.rsplit("_", 1)[0] == jkey.rsplit("_", 1)[0]
    mine = {k: v for k, v in payload.items() if k not in SUBSTRATE_KEYS}
    theirs = {k: v for k, v in jpayload.items()
              if k not in ("jax_version", "platform", "device_kind")}
    assert mine == theirs
    assert payload["torch_version"] == torch.__version__
    assert {k: payload[k] for k in SUBSTRATE_KEYS} == substrate("cpu")
    assert payload["device_type"] == "cpu" and payload["device_count"] == 1
    assert not {"jax_version", "platform", "device_kind"} & set(payload)
    # another card is another problem
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    card_key, card = problem_fingerprint(16, 2, 2, device="cuda", **kw)
    assert card["device_type"] == "cuda"
    assert card["device_name"] == "NVIDIA H100 80GB HBM3"
    assert card_key != key and card_key.rsplit("_", 1)[0] == key.rsplit("_", 1)[0]
    # the objective weights and the case are part of the problem
    assert problem_fingerprint(16, 2, 2, device="cpu", inv_weight=0.0)[0] != \
        problem_fingerprint(16, 2, 2, device="cpu")[0]


def test_plan_cache_round_trip(tmp_path, monkeypatch):
    path = str(tmp_path / "sub" / "plans.json")
    cache = PlanCache(path)
    with obs.capture() as (_, metrics):
        assert cache.get("k") is None
        cache.put("k", {"best": {"backend": "mxu"}, "us_per_call": 1.5})
        cache.put("j", {"best": {}, "us_per_call": 2.0})
        assert cache.get("k") == {"best": {"backend": "mxu"}, "us_per_call": 1.5}
    assert metrics.get("plan_cache.hits") == 1 and metrics.get("plan_cache.misses") == 1
    assert cache.keys() == ["j", "k"]
    with open(path) as f:
        assert json.load(f)["schema"] == SCHEMA
    # another schema, or a torn file, reads as empty
    with open(path, "w") as f:
        json.dump({"schema": "fft-plan-cache/v0", "entries": {"k": {}}}, f)
    assert PlanCache(path).keys() == []
    with open(path, "w") as f:
        f.write("{torn")
    assert PlanCache(path).get("k") is None
    # the port's own default file, never the reference's
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "env.json"))
    assert default_cache_path() == str(tmp_path / "env.json")
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE")
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "jax.json"))
    assert default_cache_path().endswith(
        os.path.join(".cache", "repro_torch", "fft_plans.json"))


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------

def _default_row(result):
    return next(r for r in result.rows
                if r["config"] == DEFAULT_CANDIDATE.config())


def _no_timing(*a, **k):
    raise AssertionError("a cache hit timed a candidate")


def test_autotune_on_one_rank(tmp_path, monkeypatch):
    path = str(tmp_path / "plans.json")
    res = autotune(_one(), 8, device="cpu", cache_path=path, iters=1,
                   max_candidates=3)
    assert not res.cache_hit and len(res.rows) == 4  # 3 ranked + the default
    assert res.best_us <= _default_row(res)["us_per_call"]
    assert speedup_vs_default(res) >= 1.0
    assert {"us_fwd", "us_inv"} <= set(res.rows[0])
    monkeypatch.setattr(TUNE, "time_us", _no_timing)
    hit = autotune(_one(), 8, device="cpu", cache_path=path, iters=1,
                   max_candidates=3)
    assert hit.cache_hit and hit.best_config == res.best_config
    assert hit.rows == res.rows and hit.key == res.key
    # make_fft3d(autotune=True) builds the cached winner's plan
    _, _, plan = make_fft3d(_one(), 8, device="cpu", autotune=True,
                            tune_kwargs={"cache_path": path, "iters": 1,
                                         "max_candidates": 3})
    assert plan.backend == res.best.backend and plan.chunks == res.best.chunks
    with pytest.raises(ValueError, match="weights"):
        autotune(_one(), 8, device="cpu", cache_path=path, fwd_weight=0,
                 inv_weight=0)
    with pytest.raises(ValueError, match="iters"):
        autotune(_one(), 8, device="cpu", cache_path=path, iters=0)


def test_autotune_solver_step_on_one_rank(tmp_path, monkeypatch):
    path = str(tmp_path / "plans.json")
    res = autotune_solver_step(_one(), "heat", 8, device="cpu", cache_path=path,
                               iters=1, max_candidates=4)
    assert not res.cache_hit and len(res.rows) == 5
    assert res.key.startswith("solver_heat_n8x8x8_p1x1_r2c_float64_")
    assert res.best_us <= _default_row(res)["us_per_call"]
    # the fused executor is swept for a diagonal-kernel case
    assert any(r["config"]["fused_roundtrip"] for r in res.rows)
    monkeypatch.setattr(STEP, "time_us", _no_timing)
    hit = autotune_solver_step(_one(), "heat", 8, device="cpu", cache_path=path,
                               iters=1, max_candidates=4)
    assert hit.cache_hit and hit.best_config == res.best_config
    # the solver's own key is the fingerprint of its physics params
    from repro_torch.solvers import make_solver
    solver = make_solver("heat", _one(), 8, device="cpu")
    assert solver.problem_key() == problem_fingerprint(
        8, 1, 1, real=True, dtype="float64", case="heat",
        solver_params=solver.params(), device="cpu")[0]
    with pytest.raises(ValueError, match="unknown solver case"):
        autotune_solver_step(_one(), "burgers", 8, device="cpu", cache_path=path)
    with pytest.raises(ValueError, match="iters"):
        autotune_solver_step(_one(), "heat", 8, device="cpu", cache_path=path,
                             iters=0)


def test_tuning_cli_on_the_cpu(tmp_path, capsys):
    cache, out = str(tmp_path / "plans.json"), str(tmp_path / "B.json")
    argv = ["--n", "8", "--mesh", "1x1", "--device", "cpu", "--case", "poisson",
            "--dtype", "float64", "--iters", "1", "--max-candidates", "2",
            "--cache", cache, "--json", out]
    assert tcli.main(argv) == 0
    assert "selected [measured sweep]" in capsys.readouterr().out
    assert tcli.main(argv) == 0
    assert "cache HIT (nothing re-timed)" in capsys.readouterr().out
    with open(out) as f:
        doc = json.load(f)
    assert doc["schema"] == "bench-fft/v2" and len(doc["rows"]) == 4
    assert doc["meta"]["torch_version"] == torch.__version__
    assert doc["meta"]["device_type"] == "cpu" and doc["meta"]["ranks"] == 1
    assert doc["rows"][-1]["name"].endswith("/selected")
    with pytest.raises(SystemExit, match="invalid problem for mesh 3x1"):
        tcli.main(["--n", "8", "--mesh", "3x1", "--device", "cpu"])


# ---------------------------------------------------------------------------
# no hidden failure
# ---------------------------------------------------------------------------

def _failing_solver(exc, name):
    from repro_torch import solvers
    real = solvers.make_solver

    def make_solver(case, grid, n, **kw):
        if TUNE.Candidate.from_config(kw["plan_cfg"]).name == name:
            raise exc
        return real(case, grid, n, **kw)
    return make_solver


@pytest.mark.parametrize("exc", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("fft_radix2 kernel launch failed: CUDA error 700"),
    RuntimeError("nvcc failed for fft_radix2.cu"),
])
def test_a_cuda_error_in_a_candidate_propagates(tmp_path, monkeypatch, exc):
    from repro_torch import solvers
    name = DEFAULT_CANDIDATE.name
    monkeypatch.setattr(solvers, "make_solver", _failing_solver(exc, name))
    with pytest.raises(type(exc), match=re.escape(str(exc))):
        autotune_solver_step(_one(), "heat", 8, device="cpu", iters=1,
                             max_candidates=2, cache_path=str(tmp_path / "p.json"))
    assert not os.path.exists(tmp_path / "p.json")


def test_only_validity_refusals_drop_a_candidate(tmp_path, monkeypatch, capsys):
    from repro_torch import solvers
    name = DEFAULT_CANDIDATE.name
    monkeypatch.setattr(solvers, "make_solver", _failing_solver(
        NotImplementedError("not on this grid"), name))
    res = autotune_solver_step(_one(), "heat", 8, device="cpu", iters=1,
                               max_candidates=2, verbose=True,
                               cache_path=str(tmp_path / "p.json"))
    assert [r["name"] for r in res.rows if r["name"] == name] == []
    assert len(res.rows) == 2
    assert f"tune heat/{name}: REFUSED (NotImplementedError" in capsys.readouterr().out
    # every candidate refused: nothing ran, which is an error
    monkeypatch.setattr(STEP, "_build_solver",
                        lambda *a, **k: (_ for _ in ()).throw(ValueError("no")))
    with pytest.raises(RuntimeError, match="no candidate ran"):
        autotune_solver_step(_one(), "heat", 8, device="cpu", iters=1, force=True,
                             max_candidates=2, cache_path=str(tmp_path / "p.json"))


# ---------------------------------------------------------------------------
# ranks agree
# ---------------------------------------------------------------------------

def _ranks_tune(ctx, cache_dir):
    """In each rank of a 2x1 grid: a solver-step sweep, then one in which
    rank 1 alone refuses the top-ranked candidate while building it."""
    from repro_torch import solvers

    grid = ctx.grid()
    kw = dict(device="cpu", iters=1, max_candidates=3)
    first = autotune_solver_step(grid, "nls", 8,
                                 cache_path=os.path.join(cache_dir, "a.json"), **kw)
    hit = autotune_solver_step(grid, "nls", 8,
                               cache_path=os.path.join(cache_dir, "a.json"), **kw)
    victim = first.rows[0]["name"]
    if ctx.rank == 1:
        solvers.make_solver = _failing_solver(ValueError("refused here"), victim)
    second = autotune_solver_step(grid, "nls", 8,
                                  cache_path=os.path.join(cache_dir, "b.json"), **kw)
    tuned = autotune(grid, 8, cache_path=os.path.join(cache_dir, "c.json"), **kw)
    return {"first": (first.best_config, first.rows), "hit": hit.cache_hit,
            "victim": victim, "second": [r["name"] for r in second.rows],
            "second_best": second.best_config, "tuned": tuned.best_config,
            "files": sorted(os.listdir(cache_dir))}


def test_ranks_agree_on_the_winner_and_on_refusals(tmp_path):
    out = dist.run_ranks(_ranks_tune, 2, 1, device="cpu", args=(str(tmp_path),),
                         timeout=300)
    r0, r1 = out
    # same rows (each time the max over the ranks), same winner, same cache
    assert r0["first"] == r1["first"] and r0["hit"] and r1["hit"]
    assert len(r0["first"][1]) == 4
    # rank 1's refusal dropped the candidate on both ranks
    assert r0["victim"] not in r0["second"] and r0["second"] == r1["second"]
    assert len(r0["second"]) == 3
    assert r0["second_best"] == r1["second_best"]
    assert r0["tuned"] == r1["tuned"]
    with open(tmp_path / "a.json") as f:
        (entry,) = json.load(f)["entries"].values()
    assert entry["best"] == r0["first"][0] and entry["problem"]["pu"] == 2
