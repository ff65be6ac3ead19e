"""``repro_torch.fleet`` unit coverage, test for test the reference's
``tests/test_fleet.py``: the fault-spec grammar, the structured failure
records, and the controller's supervision loop — retry, backoff mesh
reshaping, quarantine, timeout kills, env hygiene — exercised against the
same fast stub worker, which imports nothing of either package (the
real-worker integration lives in ``tests/test_torch_fleet_restart.py``).
Beside them: a job's ``device`` reaches the spec document, and a real
worker reports an invalid spec as poison on 1×1 and from its ranks.
"""

import json
import os
import subprocess
import sys

import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch import obs
from repro_torch.fleet import (Fault, FailureRecord, FleetController, FleetJob,
                               classify_exit, parse_fault_spec)
from repro_torch.fleet.faults import plan_from_env
from repro_torch.fleet.records import KILL_EXIT, POISON_EXIT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# fault-spec grammar
# ---------------------------------------------------------------------------


def test_parse_fault_spec_grammar():
    plan = parse_fault_spec(
        "kill-at-step:3; torn-checkpoint:2:times=2@job=job1;"
        "slow-at-step:1:30.5")
    assert len(plan.faults) == 3 and bool(plan)
    kill, torn, slow = plan.faults
    assert kill == Fault(kind="kill-at-step", step=3)
    assert torn.times == 2 and torn.job == "job1"
    assert slow.seconds == 30.5
    assert not parse_fault_spec("") and not parse_fault_spec(None)


def test_fault_filtering_by_job_and_attempt():
    plan = parse_fault_spec("kill-at-step:3@job=job0;torn-checkpoint:1:times=2")
    # default times=1: attempt 0 only — a retry sails through
    assert [f.kind for f in plan.active("job0", 0)] == \
        ["kill-at-step", "torn-checkpoint"]
    assert [f.kind for f in plan.active("job0", 1)] == ["torn-checkpoint"]
    assert plan.active("job0", 2) == []
    assert [f.kind for f in plan.active("job1", 0)] == ["torn-checkpoint"]


@pytest.mark.parametrize("bad", [
    "explode-at-step:3",            # unknown kind
    "kill-at-step",                 # missing step
    "kill-at-step:x",               # non-integer step
    "kill-at-step:3:5",             # extra positional arg
    "slow-at-step:3",               # missing seconds
    "kill-at-step:3:whens=2",       # unknown option
    "kill-at-step:3:times=0",       # times < 1
    "kill-at-step:3@job=",          # empty job id
    "kill-at-step:3@jid=j0",        # malformed filter
])
def test_parse_fault_spec_rejects(bad):
    with pytest.raises(ValueError):
        parse_fault_spec(bad)


def test_plan_from_env(monkeypatch):
    monkeypatch.setenv("REPRO_FAULT_SPEC", "kill-at-step:7")
    assert plan_from_env().faults[0].step == 7
    monkeypatch.delenv("REPRO_FAULT_SPEC")
    assert not plan_from_env()
    assert plan_from_env("slow-at-step:1:2").faults[0].seconds == 2.0


# ---------------------------------------------------------------------------
# failure records + exit classification
# ---------------------------------------------------------------------------

def test_failure_record_roundtrip_and_validation():
    rec = FailureRecord(kind="timeout", where="fleet.worker", job_id="j0",
                        attempt=1, detail="deadline", exit_code=None,
                        retryable=True, time_s=1.5)
    clone = FailureRecord.from_dict({**rec.to_dict(), "extra": "ignored"})
    assert clone == rec
    with pytest.raises(ValueError, match="unknown failure kind"):
        FailureRecord(kind="gremlin", where="x", job_id="j0")


def test_classify_exit():
    assert classify_exit(POISON_EXIT) == ("poison", False)
    assert classify_exit(KILL_EXIT) == ("crash", True)
    assert classify_exit(1) == ("crash", True)


# ---------------------------------------------------------------------------
# the controller against a stub worker (nothing of either package in it)
# ---------------------------------------------------------------------------

_STUB = r'''
import argparse, json, os, sys, time

ap = argparse.ArgumentParser()
ap.add_argument("--spec")
ap.add_argument("--attempt", type=int, default=0)
a = ap.parse_args()
with open(a.spec) as f:
    spec = json.load(f)
mode = spec["params"].get("mode", "ok")
if mode == "poison":
    sys.exit(4)                                   # records.POISON_EXIT
if mode == "hang":
    time.sleep(60)
if mode == "crash-once" and a.attempt == 0:
    with open(spec["progress_path"], "a") as f:
        f.write(json.dumps({"step": 0, "attempt": 0,
                            "obs": {"amp": 1.0}}) + "\n")
        f.write('{"step": 1, "att')               # torn tail, then die
        f.flush()
    os._exit(13)                                  # records.KILL_EXIT
for step in range(spec["steps"] + 1):
    obs = {"amp": 1.0 / (step + 1), "mesh": spec["mesh"]}
    if mode == "env":
        obs = {"has_xla": int("XLA_FLAGS" in os.environ),
               "fault": os.environ.get("REPRO_FAULT_SPEC", "")}
    with open(spec["progress_path"], "a") as f:
        f.write(json.dumps({"step": step, "attempt": a.attempt,
                            "obs": obs}) + "\n")
tmp = spec["result_path"] + ".tmp"
with open(tmp, "w") as f:
    json.dump({"job_id": spec["job_id"], "attempt": a.attempt,
               "final_step": spec["steps"], "restore_latency_us": 12.5,
               "checkpoint_bytes": 2048}, f)
os.replace(tmp, spec["result_path"])
'''


@pytest.fixture()
def stub(tmp_path):
    path = tmp_path / "stub_worker.py"
    path.write_text(_STUB)
    return (sys.executable, str(path))


def _job(jid, mode, **kw):
    kw.setdefault("steps", 3)
    kw.setdefault("mesh", (1, 1))
    return FleetJob(job_id=jid, case="heat", params={"mode": mode}, **kw)


def _controller(jobs, stub, tmp_path, **kw):
    kw.setdefault("total_slots", 4)
    kw.setdefault("backoff_base_s", 0.01)
    kw.setdefault("backoff_cap_s", 0.05)
    kw.setdefault("verbose", False)
    return FleetController(jobs, workdir=str(tmp_path / "work"),
                           worker_argv=stub, **kw)


def test_crash_is_retried_and_completes(stub, tmp_path):
    ctl = _controller([_job("j0", "crash-once")], stub, tmp_path)
    with obs.capture() as (_, metrics):
        results = ctl.run()
    res = results["j0"]
    assert res.ok and res.attempts == 2
    assert [f.kind for f in res.failures] == ["crash"]
    assert res.failures[0].exit_code == KILL_EXIT and res.failures[0].retryable
    # torn tail tolerated; attempt-1 lines win the merge
    assert sorted(res.history) == [0, 1, 2, 3]
    assert res.final_observables()["amp"] == 0.25
    assert res.restore_latency_us == 12.5 and res.checkpoint_bytes == 2048
    assert ctl.counters["fleet.jobs.scheduled"] == 2
    assert ctl.counters["fleet.jobs.retried"] == 1
    assert ctl.counters["fleet.jobs.failures"] == 1
    assert ctl.counters["fleet.jobs.completed"] == 1
    assert ctl.counters["fleet.jobs.quarantined"] == 0
    # mirrored into repro_torch.obs when tracing is on
    assert metrics.counters()["fleet.jobs.retried"] == 1


def test_poison_quarantines_without_retry_and_siblings_survive(stub, tmp_path):
    ctl = _controller([_job("bad", "poison"), _job("good", "ok")],
                      stub, tmp_path, max_retries=3)
    results = ctl.run()
    bad, good = results["bad"], results["good"]
    assert bad.status == "quarantined" and bad.attempts == 1
    assert [(f.kind, f.retryable) for f in bad.failures] == [("poison", False)]
    assert bad.failures[0].exit_code == POISON_EXIT
    assert good.ok and good.attempts == 1          # never blocked on bad
    assert ctl.counters["fleet.jobs.quarantined"] == 1
    assert ctl.counters["fleet.jobs.retried"] == 0


def test_timeout_kill_is_classified_and_budget_quarantines(stub, tmp_path):
    ctl = _controller([_job("hung", "hang")], stub, tmp_path,
                      max_retries=0, timeout_s=0.5)
    results = ctl.run()
    res = results["hung"]
    assert res.status == "quarantined"
    assert [f.kind for f in res.failures] == ["timeout"]
    assert "deadline" in res.failures[0].detail


def test_retry_budget_exhaustion_collects_the_full_trail(stub, tmp_path):
    # every attempt poisons itself crash-like? no — hang at tiny timeout
    ctl = _controller([_job("hung", "hang")], stub, tmp_path,
                      max_retries=2, timeout_s=0.3)
    results = ctl.run()
    res = results["hung"]
    assert res.status == "quarantined" and res.attempts == 3
    assert [f.kind for f in res.failures] == ["timeout"] * 3
    assert [f.attempt for f in res.failures] == [0, 1, 2]


def test_reshape_on_retry_changes_the_attempt_submesh(stub, tmp_path):
    ctl = _controller([_job("j0", "crash-once", mesh=(2, 1))], stub, tmp_path,
                      reshape_on_retry=((1, 2), (2, 2)))
    assert ctl._retry_mesh(ctl.jobs[0], 0) == (2, 1)
    assert ctl._retry_mesh(ctl.jobs[0], 1) == (1, 2)
    assert ctl._retry_mesh(ctl.jobs[0], 2) == (2, 2)
    assert ctl._retry_mesh(ctl.jobs[0], 3) == (1, 2)
    results = ctl.run()
    assert results["j0"].ok
    # the retried attempt's spec really carried the reshaped submesh
    with open(os.path.join(ctl.workdir, "j0.attempt1.spec.json")) as f:
        assert json.load(f)["mesh"] == [1, 2]
    assert results["j0"].history[3]["mesh"] == [1, 2]


def test_worker_env_is_scrubbed_and_faults_forwarded(stub, tmp_path,
                                                     monkeypatch):
    # the port reads no XLA_FLAGS, so the controller leaves it in the
    # worker's environment; an inherited fault spec is the one variable it
    # owns: cleared without a spec of its own, replaced by one
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    monkeypatch.setenv("REPRO_FAULT_SPEC", "kill-at-step:1")
    ctl = _controller([_job("j0", "env")], stub, tmp_path / "none")
    obs0 = ctl.run()["j0"].history[0]
    assert obs0["fault"] == ""             # an inherited spec must not leak in
    assert obs0["has_xla"] == 1
    spec = "kill-at-step:99@job=nobody"
    ctl = _controller([_job("j0", "env")], stub, tmp_path, fault_spec=spec)
    results = ctl.run()
    obs0 = results["j0"].history[0]
    assert obs0["fault"] == spec           # spec rides the env to the worker


def test_controller_validates_before_launching(stub, tmp_path):
    with pytest.raises(ValueError, match="duplicate job ids"):
        _controller([_job("a", "ok"), _job("a", "ok")], stub, tmp_path)
    with pytest.raises(ValueError, match="needs 8 slots"):
        _controller([_job("big", "ok", mesh=(4, 2))], stub, tmp_path,
                    total_slots=4)
    with pytest.raises(ValueError, match="exceeds the 4-slot pool"):
        _controller([_job("a", "ok")], stub, tmp_path,
                    reshape_on_retry=((8, 1),))
    with pytest.raises(ValueError, match="unknown fault kind"):
        _controller([_job("a", "ok")], stub, tmp_path,
                    fault_spec="explode:1")


def test_report_schema_is_json_serializable(stub, tmp_path):
    ctl = _controller([_job("j0", "crash-once"), _job("bad", "poison")],
                      stub, tmp_path)
    results = ctl.run()
    doc = json.loads(json.dumps(ctl.report(results)))
    assert doc["schema"] == "fleet-report/v1"
    assert doc["counters"]["fleet.jobs.completed"] == 1
    assert set(doc["jobs"]) == {"j0", "bad"}
    assert doc["jobs"]["j0"]["status"] == "completed"
    assert doc["jobs"]["j0"]["final_step"] == 3
    assert doc["jobs"]["bad"]["failures"][0]["kind"] == "poison"


# ---------------------------------------------------------------------------
# the CLI's ensemble (build_jobs; no subprocess)
# ---------------------------------------------------------------------------

def test_cli_build_jobs_sweep_and_replicas():
    from repro_torch.fleet.cli import build_jobs, build_parser

    ap = build_parser()
    sweep = build_jobs(ap.parse_args(
        ["--sweep", "kappa=0.05,0.1,0.2", "--submesh", "2x2"]))
    assert [j.params for j in sweep] == \
        [{"kappa": 0.05}, {"kappa": 0.1}, {"kappa": 0.2}]
    assert all(j.mesh == (2, 2) for j in sweep)
    reps = build_jobs(ap.parse_args(["--jobs", "3"]))
    assert [j.scale for j in reps] == [1.0, 1.25, 1.5]
    assert [j.job_id for j in reps] == ["job0", "job1", "job2"]
    with pytest.raises(SystemExit):
        build_jobs(ap.parse_args(["--submesh", "banana"]))
    with pytest.raises(SystemExit):
        build_jobs(ap.parse_args(["--sweep", "kappa"]))
    with pytest.raises(SystemExit):
        build_jobs(ap.parse_args(["--jobs", "0"]))


# ---------------------------------------------------------------------------
# the port's own: the job's device, and poison from a real worker
# ---------------------------------------------------------------------------

def test_job_device_reaches_the_spec(stub, tmp_path):
    job = FleetJob(job_id="j0", case="heat")
    assert job.device == "cuda"
    spec = job.spec_dict(mesh=(1, 1), ckpt_dir="c", result_path="r",
                         progress_path="p", ckpt_every=2, keep=2)
    assert spec["device"] == "cuda"
    # every reference key is there, and nothing else but the device
    assert set(spec) == {"job_id", "case", "n", "steps", "mesh", "dt", "dtype",
                         "params", "plan_cfg", "scale", "ckpt_dir", "ckpt_every",
                         "keep", "result_path", "progress_path", "device"}
    ctl = _controller([_job("j0", "ok", device="cpu")], stub, tmp_path)
    assert ctl.run()["j0"].ok
    with open(os.path.join(ctl.workdir, "j0.attempt0.spec.json")) as f:
        assert json.load(f)["device"] == "cpu"
    from repro_torch.fleet.cli import build_jobs, build_parser
    jobs = build_jobs(build_parser().parse_args(["--jobs", "2", "--device", "cpu"]))
    assert [j.device for j in jobs] == ["cpu", "cpu"]
    assert build_jobs(build_parser().parse_args(["--jobs", "1"]))[0].device == "cuda"


@pytest.mark.parametrize("mesh", [(1, 1), (2, 1)])
def test_real_worker_reports_an_invalid_spec_as_poison(tmp_path, mesh):
    # every rank raises the same ValueError in make_solver: the worker exits
    # POISON_EXIT, not as a crash of its ranks
    spec = FleetJob(job_id="bad", case="no_such_case", n=8, mesh=mesh,
                    device="cpu").spec_dict(
        mesh=mesh, ckpt_dir=str(tmp_path / "ckpt"),
        result_path=str(tmp_path / "r.json"),
        progress_path=str(tmp_path / "p.jsonl"), ckpt_every=2, keep=2)
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    env = {k: v for k, v in os.environ.items() if k != "REPRO_FAULT_SPEC"}
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    r = subprocess.run([sys.executable, "-m", "repro_torch.fleet.worker",
                        "--spec", str(path), "--attempt", "0"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == POISON_EXIT, r.stdout + r.stderr
    assert "[poison] ValueError: unknown solver case" in r.stderr
    assert "[ranks]" not in r.stderr
