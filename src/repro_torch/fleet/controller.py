"""The fleet controller: supervised subprocess workers over submesh slots.

Port of ``repro.fleet.controller`` (which imports no jax; the port keeps
its own copy and imports nothing of ``repro``).

One :class:`FleetController` runs an *ensemble* — many independent solver
jobs (a parameter sweep, replicas at different amplitudes) — against a
fixed pool of device slots. Each :class:`FleetJob` names a registered
``repro_torch.solvers`` case, a horizon in Δt steps, and the Pu×Pv submesh shape
it runs on; the controller packs jobs onto the pool (a job occupies
``pu·pv`` slots while running), launches each as a supervised
``python -m repro_torch.fleet.worker`` subprocess, and babysits it to completion.

**Failure handling** is the whole point. When a worker dies the controller
classifies the death:

* ``crash``   — nonzero exit (incl. the fault injector's hard kill):
  retryable;
* ``timeout`` — the worker outlived its deadline and was killed by the
  supervisor (wedged collective, injected ``slow-at-step``): retryable;
* ``poison``  — the worker reported an invalid job spec
  (``records.POISON_EXIT``): deterministic, never retried.

Retryable failures are rescheduled from the job's **latest checkpoint**
(the worker resumes automatically via ``SpectralSolver.restore_state``)
with capped exponential backoff, up to a per-job retry budget. A job that
exhausts its budget is **quarantined** with its full
:class:`~repro.fleet.records.FailureRecord` trail — and the rest of the
ensemble keeps running: graceful degradation, never a wedged campaign.
Because checkpoints restore elastically, a retry may even land on a
*different* submesh shape (``reshape_on_retry``).

**Slots are rank processes.** A job on a ``pu×pv`` submesh runs as
``pu·pv`` processes (the worker itself on 1×1, else its rank processes,
:func:`repro_torch.dist.run_ranks`), and the slot ledger counts those
processes, not cards: rank ``r`` runs on ``cuda:{r % device_count}``, so on
one H100 every running rank of every worker shares the card.  Each job
names its ``device`` (``"cuda"`` by default, ``"cpu"`` for a host run) in
its spec.  The port reads no ``XLA_FLAGS``, so the worker's environment
keeps it; only ``REPRO_FAULT_SPEC`` is set or cleared.  Each worker leads
a process group of its own, and a timeout or a failed exit kills the whole
group, so no rank process of a dead worker lingers on the card.

Counters (mirrored into ``repro_torch.obs`` when tracing and always available on
``FleetController.counters`` for the report): ``fleet.jobs.scheduled`` /
``completed`` / ``failures`` / ``retried`` / ``quarantined``, plus
``fleet.checkpoint.bytes`` and the ``fleet.restore.latency_us`` gauge
aggregated from worker reports.

This module never touches the card — only the workers do, and a CUDA
context here would hold card memory that no worker uses.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import time

from repro_torch import obs
from repro_torch.fleet import faults as _faults
from repro_torch.fleet.records import FailureRecord, classify_exit

_COUNTERS = ("fleet.jobs.scheduled", "fleet.jobs.completed",
             "fleet.jobs.failures", "fleet.jobs.retried",
             "fleet.jobs.quarantined", "fleet.checkpoint.bytes")


@dataclasses.dataclass(frozen=True)
class FleetJob:
    """One ensemble member: a solver problem plus its submesh claim."""

    job_id: str
    case: str
    n: int | tuple = 16
    steps: int = 4
    mesh: tuple = (2, 1)            # (pu, pv) submesh shape
    dt: float | None = None
    dtype: str = "float64"
    params: dict = dataclasses.field(default_factory=dict)
    plan_cfg: dict | None = None
    scale: float = 1.0              # initial-condition amplitude
    device: str = "cuda"            # where the job's ranks run

    @property
    def slots(self) -> int:
        return int(math.prod(self.mesh))

    def spec_dict(self, *, mesh, ckpt_dir: str, result_path: str,
                  progress_path: str, ckpt_every: int, keep: int) -> dict:
        """The JSON document one worker attempt runs from."""
        n = self.n if isinstance(self.n, int) else list(self.n)
        return {"job_id": self.job_id, "case": self.case, "n": n,
                "steps": int(self.steps), "mesh": list(mesh),
                "dt": self.dt, "dtype": self.dtype,
                "params": dict(self.params),
                "plan_cfg": dict(self.plan_cfg) if self.plan_cfg else None,
                "scale": float(self.scale), "device": self.device,
                "ckpt_dir": ckpt_dir,
                "ckpt_every": int(ckpt_every), "keep": int(keep),
                "result_path": result_path, "progress_path": progress_path}


@dataclasses.dataclass
class JobResult:
    """Terminal state of one job after the campaign."""

    job: FleetJob
    status: str = "pending"         # completed | quarantined
    attempts: int = 0
    history: dict = dataclasses.field(default_factory=dict)  # step -> obs
    failures: list = dataclasses.field(default_factory=list)
    restore_latency_us: float = 0.0
    checkpoint_bytes: int = 0

    @property
    def ok(self) -> bool:
        return self.status == "completed"

    def final_observables(self) -> dict | None:
        if not self.history:
            return None
        return self.history[max(self.history)]

    def to_dict(self) -> dict:
        return {"job_id": self.job.job_id, "case": self.job.case,
                "status": self.status, "attempts": self.attempts,
                "final_step": max(self.history) if self.history else None,
                "restore_latency_us": self.restore_latency_us,
                "checkpoint_bytes": self.checkpoint_bytes,
                "failures": [f.to_dict() for f in self.failures],
                "history": {str(k): self.history[k]
                            for k in sorted(self.history)}}


@dataclasses.dataclass
class _Attempt:
    job: FleetJob
    attempt: int
    mesh: tuple
    eligible_s: float = 0.0         # monotonic time the backoff expires


@dataclasses.dataclass
class _Running:
    att: _Attempt
    proc: subprocess.Popen
    deadline_s: float
    log_path: str
    result_path: str


class FleetController:
    """Schedule, supervise, retry and quarantine an ensemble of jobs."""

    def __init__(self, jobs, *, workdir: str, total_slots: int = 8,
                 max_retries: int = 2, timeout_s: float = 600.0,
                 backoff_base_s: float = 0.25, backoff_cap_s: float = 4.0,
                 ckpt_every: int = 2, keep: int = 2, fault_spec: str = "",
                 reshape_on_retry: tuple = (), poll_s: float = 0.02,
                 worker_argv: tuple | None = None, verbose: bool = True):
        self.jobs = list(jobs)
        ids = [j.job_id for j in self.jobs]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate job ids: {ids}")
        for j in self.jobs:
            if j.slots > total_slots:
                raise ValueError(f"job {j.job_id} needs {j.slots} slots, "
                                 f"pool has {total_slots}")
        for shape in reshape_on_retry:
            if math.prod(shape) > total_slots:
                raise ValueError(f"reshape_on_retry shape {shape} exceeds "
                                 f"the {total_slots}-slot pool")
        _faults.parse_fault_spec(fault_spec)   # fail fast on a bad spec
        self.workdir = workdir
        self.total_slots = int(total_slots)
        self.max_retries = int(max_retries)
        self.timeout_s = float(timeout_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.ckpt_every = int(ckpt_every)
        self.keep = int(keep)
        self.fault_spec = fault_spec
        self.reshape_on_retry = tuple(tuple(s) for s in reshape_on_retry)
        self.poll_s = float(poll_s)
        self.worker_argv = tuple(worker_argv) if worker_argv else (
            sys.executable, "-m", "repro_torch.fleet.worker")
        self.verbose = verbose
        self.counters: dict[str, float] = {k: 0 for k in _COUNTERS}
        os.makedirs(workdir, exist_ok=True)

    # ---- bookkeeping -----------------------------------------------------
    def _count(self, name: str, value: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + value
        obs.metrics.inc(name, value)

    def _say(self, msg: str) -> None:
        if self.verbose:
            print(f"[fleet] {msg}", flush=True)

    def _retry_mesh(self, job: FleetJob, attempt: int) -> tuple:
        """Submesh shape for a retry — cycles ``reshape_on_retry`` when set
        (elastic restore onto a different pencil grid), else the job's own."""
        if attempt == 0 or not self.reshape_on_retry:
            return tuple(job.mesh)
        return self.reshape_on_retry[(attempt - 1) % len(self.reshape_on_retry)]

    # ---- the supervision loop --------------------------------------------
    def run(self) -> dict[str, JobResult]:
        """Run the campaign to completion; every job ends ``completed`` or
        ``quarantined`` (this method never wedges on a single job)."""
        results = {j.job_id: JobResult(job=j) for j in self.jobs}
        pending = collections.deque(
            _Attempt(job=j, attempt=0, mesh=tuple(j.mesh)) for j in self.jobs)
        running: dict[str, _Running] = {}
        try:
            self._supervise(results, pending, running)
        finally:
            for run_ in running.values():      # interrupted: leave nothing behind
                self._kill_group(run_)
                run_.proc.wait()
        for res in results.values():
            self._merge_history(res)
        return results

    def _supervise(self, results, pending, running) -> None:
        while pending or running:
            now = time.monotonic()
            # launch every eligible pending attempt that fits the free pool
            free = self.total_slots - sum(
                r.att.job.slots for r in running.values())
            deferred = collections.deque()
            while pending:
                att = pending.popleft()
                slots = int(math.prod(att.mesh))
                if att.eligible_s > now or slots > free:
                    deferred.append(att)
                    continue
                running[att.job.job_id] = self._launch(att)
                results[att.job.job_id].attempts = att.attempt + 1
                free -= slots
            pending = deferred

            progressed = False
            for job_id in list(running):
                run_ = running[job_id]
                rc = run_.proc.poll()
                if rc is None and time.monotonic() > run_.deadline_s:
                    self._kill_group(run_)
                    run_.proc.wait()
                    del running[job_id]
                    self._on_failure(results[job_id], run_, "timeout", True,
                                     f"exceeded {self.timeout_s:g}s deadline",
                                     None, pending)
                    progressed = True
                elif rc is not None:
                    del running[job_id]
                    if rc == 0:
                        self._collect(results[job_id], run_)
                    else:
                        self._kill_group(run_)     # ranks it left behind
                        kind, retryable = classify_exit(rc)
                        self._on_failure(results[job_id], run_, kind,
                                         retryable, self._log_tail(run_),
                                         rc, pending)
                    progressed = True
            if not progressed and (running or pending):
                time.sleep(self.poll_s)

    # ---- launch / collect / fail -----------------------------------------
    def _paths(self, job: FleetJob, attempt: int) -> dict:
        base = os.path.join(self.workdir, job.job_id)
        return {"spec": f"{base}.attempt{attempt}.spec.json",
                "log": f"{base}.attempt{attempt}.log",
                "result": f"{base}.result.json",
                "progress": f"{base}.progress.jsonl",
                "ckpt": os.path.join(self.workdir, "ckpt", job.job_id)}

    def _launch(self, att: _Attempt) -> _Running:
        p = self._paths(att.job, att.attempt)
        spec = att.job.spec_dict(
            mesh=att.mesh, ckpt_dir=p["ckpt"], result_path=p["result"],
            progress_path=p["progress"], ckpt_every=self.ckpt_every,
            keep=self.keep)
        with open(p["spec"], "w") as f:
            json.dump(spec, f, indent=1)
        env = dict(os.environ)
        if self.fault_spec:
            env["REPRO_FAULT_SPEC"] = self.fault_spec
        else:
            env.pop("REPRO_FAULT_SPEC", None)
        log = open(p["log"], "ab")
        proc = subprocess.Popen(
            [*self.worker_argv, "--spec", p["spec"],
             "--attempt", str(att.attempt)],
            stdout=log, stderr=subprocess.STDOUT, env=env,
            start_new_session=True)
        log.close()
        self._count("fleet.jobs.scheduled")
        pu, pv = att.mesh
        self._say(f"job {att.job.job_id} attempt {att.attempt} -> "
                  f"{pu}x{pv} submesh (pid {proc.pid})")
        return _Running(att=att, proc=proc,
                        deadline_s=time.monotonic() + self.timeout_s,
                        log_path=p["log"], result_path=p["result"])

    @staticmethod
    def _kill_group(run_: _Running) -> None:
        """SIGKILL the worker's process group: the worker and its ranks."""
        try:
            os.killpg(run_.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass                            # the group is gone already

    def _log_tail(self, run_: _Running, nbytes: int = 800) -> str:
        try:
            with open(run_.log_path, "rb") as f:
                f.seek(max(0, os.path.getsize(run_.log_path) - nbytes))
                return f.read().decode(errors="replace").strip()
        except OSError:
            return ""

    def _collect(self, res: JobResult, run_: _Running) -> None:
        try:
            with open(run_.result_path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            doc = {}
        res.status = "completed"
        res.restore_latency_us = float(doc.get("restore_latency_us", 0.0))
        res.checkpoint_bytes = int(doc.get("checkpoint_bytes", 0))
        self._count("fleet.jobs.completed")
        self._count("fleet.checkpoint.bytes", res.checkpoint_bytes)
        if res.restore_latency_us:
            obs.metrics.set_gauge("fleet.restore.latency_us",
                                  res.restore_latency_us)
        self._say(f"job {res.job.job_id} completed "
                  f"({res.attempts} attempt(s))")

    def _on_failure(self, res: JobResult, run_: _Running, kind: str,
                    retryable: bool, detail: str, rc: int | None,
                    pending: collections.deque) -> None:
        att = run_.att
        res.failures.append(FailureRecord(
            kind=kind, where="fleet.worker", job_id=att.job.job_id,
            attempt=att.attempt, detail=detail, exit_code=rc,
            retryable=retryable, time_s=time.time()))
        self._count("fleet.jobs.failures")
        if retryable and att.attempt < self.max_retries:
            delay = min(self.backoff_cap_s,
                        self.backoff_base_s * (2 ** att.attempt))
            mesh = self._retry_mesh(att.job, att.attempt + 1)
            pending.append(_Attempt(
                job=att.job, attempt=att.attempt + 1, mesh=mesh,
                eligible_s=time.monotonic() + delay))
            self._count("fleet.jobs.retried")
            self._say(f"job {att.job.job_id} {kind} on attempt "
                      f"{att.attempt}; retry in {delay:.2f}s on "
                      f"{mesh[0]}x{mesh[1]}")
        else:
            res.status = "quarantined"
            self._count("fleet.jobs.quarantined")
            self._say(f"job {att.job.job_id} QUARANTINED after "
                      f"{att.attempt + 1} attempt(s): {kind}")

    def _merge_history(self, res: JobResult) -> None:
        """Merge the job's append-only progress log into ``{step: obs}``.

        Every attempt appends to the same file; later attempts overwrite
        overlapping steps (they recompute the same values from the restored
        checkpoint — the identity the chaos smoke pins). A torn final line
        from a hard kill is tolerated.
        """
        path = self._paths(res.job, 0)["progress"]
        if not os.path.exists(path):
            return
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue            # torn tail from a mid-write kill
                res.history[int(rec["step"])] = rec["obs"]

    # ---- reporting -------------------------------------------------------
    def report(self, results: dict[str, JobResult]) -> dict:
        """The JSON-serializable campaign report (``fleet-report/v1``)."""
        return {"schema": "fleet-report/v1",
                "counters": dict(self.counters),
                "config": {"total_slots": self.total_slots,
                           "max_retries": self.max_retries,
                           "ckpt_every": self.ckpt_every,
                           "fault_spec": self.fault_spec,
                           "timeout_s": self.timeout_s},
                "jobs": {jid: results[jid].to_dict()
                         for jid in sorted(results)}}
