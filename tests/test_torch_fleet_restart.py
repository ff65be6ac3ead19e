"""Campaign-level fleet fault tolerance on the port, on the CPU: the
reference's ``tests/test_fleet_restart.py`` against
``python -m repro_torch.fleet.cli --device cpu``.  Kill-injected workers
(each a 2x1 grid of rank processes) resume from their checkpoints and land
on observables identical to the unkilled campaign; a job with an exhausted
retry budget is quarantined without wedging its sibling; a retry resumed
onto another grid (1x2) stays within 1e-10 of the clean campaign; and the
port's clean campaign stays within 1e-10 of the JAX package's fleet
(``python -m repro.fleet.cli``, same flags) at every step.

The five campaigns are independent, so they start together (one module
fixture) and each test waits for the ones it reads.
"""

import json
import os
import subprocess
import sys

import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch.solvers.base import observables_rel_err

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ("--case", "heat", "--n", "16", "--steps", "4", "--jobs", "2",
         "--submesh", "2x1", "--slots", "4", "--ckpt-every", "2")
# name -> (package, extra flags)
CAMPAIGNS = {
    "clean": ("repro_torch", ()),
    "chaos": ("repro_torch", ("--inject", "kill-at-step:3")),
    "quarantine": ("repro_torch", ("--inject", "kill-at-step:1:times=99@job=job0",
                                   "--max-retries", "1")),
    "reshape": ("repro_torch", ("--inject", "kill-at-step:3",
                                "--reshape-on-retry", "1x2")),
    "jax": ("repro", ()),
}


class _Campaign:
    def __init__(self, base, name, package, extra):
        self.workdir = str(base / name)
        self.report = str(base / f"{name}.json")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.join(REPO, "src")
        env.pop("XLA_FLAGS", None)
        env.pop("REPRO_FAULT_SPEC", None)
        device = ("--device", "cpu") if package == "repro_torch" else ()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", f"{package}.fleet.cli", *FLAGS, *device,
             "--workdir", self.workdir, "--report", self.report, *extra],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._out = None

    def wait(self):
        if self._out is None:
            out, err = self.proc.communicate(timeout=600)
            self._out = (self.proc.returncode, out, err)
        return self._out

    def doc(self):
        with open(self.report) as f:
            doc = json.load(f)
        assert doc["schema"] == "fleet-report/v1"
        return doc


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    base = tmp_path_factory.mktemp("fleet")
    runs = {name: _Campaign(base, name, pkg, extra)
            for name, (pkg, extra) in CAMPAIGNS.items()}
    yield runs
    for run in runs.values():
        if run.proc.poll() is None:
            run.proc.kill()
        run.proc.communicate()


def _ok(run, rc=0):
    code, out, err = run.wait()
    assert code == rc, (out[-1500:], err[-3000:])
    return out


def test_killed_ensemble_resumes_to_identical_observables(campaigns):
    _ok(campaigns["clean"])
    out = _ok(campaigns["chaos"])
    assert "retry in" in out                     # the controller rescheduled

    ref, got = campaigns["clean"].doc(), campaigns["chaos"].doc()
    assert ref["counters"]["fleet.jobs.retried"] == 0
    assert got["counters"]["fleet.jobs.retried"] == 2
    assert got["counters"]["fleet.jobs.quarantined"] == 0
    for jid in ("job0", "job1"):
        cj, kj = ref["jobs"][jid], got["jobs"][jid]
        assert cj["status"] == kj["status"] == "completed"
        assert cj["attempts"] == 1 and kj["attempts"] == 2
        assert kj["failures"][0]["kind"] == "crash"
        # every rank exited with KILL_EXIT, and so did the worker
        assert kj["failures"][0]["exit_code"] == 13
        # the headline identity: the merged per-step observables of the
        # killed-and-resumed run equal the unkilled run's, bit for bit
        assert kj["history"] == cj["history"], jid
        assert sorted(map(int, kj["history"])) == [0, 1, 2, 3, 4]
        assert kj["restore_latency_us"] > 0      # it really resumed
    # the retried attempt resumed from the step-2 snapshot
    logs = [n for n in os.listdir(campaigns["chaos"].workdir)
            if n.endswith(".attempt1.log")]
    assert len(logs) == 2
    for log in logs:
        with open(os.path.join(campaigns["chaos"].workdir, log)) as f:
            assert "[resume]" in f.read()


def test_exhausted_job_is_quarantined_without_blocking_siblings(campaigns):
    # quarantine => campaign exit code 1, but the campaign still finished
    out = _ok(campaigns["quarantine"], rc=1)
    assert "QUARANTINED" in out
    doc = campaigns["quarantine"].doc()
    j0, j1 = doc["jobs"]["job0"], doc["jobs"]["job1"]
    assert j0["status"] == "quarantined" and j0["attempts"] == 2
    assert [f["kind"] for f in j0["failures"]] == ["crash", "crash"]
    assert all(f["exit_code"] == 13 for f in j0["failures"])
    assert j1["status"] == "completed" and j1["attempts"] == 1
    assert doc["counters"]["fleet.jobs.quarantined"] == 1


def test_retry_resumes_onto_another_grid(campaigns):
    _ok(campaigns["clean"])
    _ok(campaigns["reshape"])
    ref, got = campaigns["clean"].doc(), campaigns["reshape"].doc()
    work = campaigns["reshape"].workdir
    for jid in ("job0", "job1"):
        cj, kj = ref["jobs"][jid], got["jobs"][jid]
        assert kj["status"] == "completed" and kj["attempts"] == 2
        with open(os.path.join(work, f"{jid}.attempt1.spec.json")) as f:
            assert json.load(f)["mesh"] == [1, 2]
        with open(os.path.join(work, f"{jid}.attempt1.log")) as f:
            assert "from step 2 (saved on mesh [2, 1]" in f.read()
        assert sorted(kj["history"]) == sorted(cj["history"])
        for step, want in cj["history"].items():
            have = kj["history"][step]
            assert have["t"] == want["t"]
            assert observables_rel_err(have, want) <= 1e-10, (jid, step)
        # steps 0-2 ran on the 2x1 grid of the clean campaign: bitwise
        for step in ("0", "1", "2"):
            assert kj["history"][step] == cj["history"][step]


def test_port_campaign_tracks_the_jax_fleet(campaigns):
    _ok(campaigns["clean"])
    _ok(campaigns["jax"])
    port, ref = campaigns["clean"].doc(), campaigns["jax"].doc()
    assert set(port["jobs"]) == set(ref["jobs"]) == {"job0", "job1"}
    for jid, rj in ref["jobs"].items():
        pj = port["jobs"][jid]
        assert pj["status"] == rj["status"] == "completed"
        assert sorted(pj["history"]) == sorted(rj["history"])
        for step, want in rj["history"].items():
            have = pj["history"][step]
            assert set(have) == set(want) and have["t"] == want["t"]
            assert observables_rel_err(have, want) <= 1e-10, (jid, step)
