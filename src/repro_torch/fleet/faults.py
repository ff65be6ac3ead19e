"""Deterministic fault injection for the fleet — chaos you can assert on.

Copy of ``repro.fleet.faults`` (which imports no jax; the port keeps its
own copy and imports nothing of ``repro``): the same grammar, the same
``REPRO_FAULT_SPEC`` variable, so one spec drives either package's fleet.

The point of injected faults is a *reproducible* proof: a worker killed at
step N must resume from its checkpoint and finish with observables
identical to the unkilled run. So every fault is keyed on (job, attempt,
step), never on wall time or randomness, and by default fires on attempt 0
only — the retried attempt sails through, exactly like a real preemption
that doesn't repeat.

Spec grammar (``REPRO_FAULT_SPEC`` env var, or ``--inject`` on the fleet
CLI — the controller forwards it to workers through the environment)::

    spec    := clause (";" clause)*
    clause  := kind ":" args ("@job=" JOB_ID)?

    kill-at-step:N[:times=T]        hard ``os._exit(KILL_EXIT)`` right
                                    after step N completes, skipping every
                                    cleanup path (in-flight snapshot writes
                                    are drained first, so whether the retry
                                    resumes depends only on the checkpoint
                                    cadence — use torn-checkpoint for the
                                    mid-write-tear case)
    torn-checkpoint:N[:times=T]     the first checkpoint save at step >= N
                                    writes a partial tmp dir and raises
                                    inside the async writer (exercises the
                                    CheckpointManager error capture and
                                    the scan-fallback restore)
    slow-at-step:N:SECONDS[:times=T]   sleep SECONDS after step N — long
                                    enough to trip the supervisor's
                                    deadline and be classified ``timeout``

``times=T`` fires the fault on attempts ``0 .. T-1`` (default 1);
``@job=ID`` restricts a clause to one job (default: every job). Unknown
kinds or malformed clauses raise ``ValueError`` at parse time — the
controller validates the spec *before* launching anything.

This module imports neither torch nor anything of the card: the worker
parses its spec before it builds a solver, and the controller, which never
touches the card, parses it before it launches anything.
"""

from __future__ import annotations

import dataclasses
import os

_KINDS = ("kill-at-step", "torn-checkpoint", "slow-at-step")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One armed fault clause."""

    kind: str                   # one of _KINDS
    step: int                   # the step the fault keys on
    seconds: float = 0.0        # slow-at-step only
    times: int = 1              # fires on attempts < times
    job: str = ""               # "" = every job

    def fires(self, job_id: str, attempt: int) -> bool:
        return (not self.job or self.job == job_id) and attempt < self.times


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A parsed spec: the full set of clauses, filterable per (job, attempt)."""

    faults: tuple = ()

    def active(self, job_id: str, attempt: int) -> list:
        """The clauses that fire for this job on this attempt."""
        return [f for f in self.faults if f.fires(job_id, attempt)]

    def __bool__(self) -> bool:
        return bool(self.faults)


def parse_fault_spec(text: str | None) -> FaultPlan:
    """Parse the grammar above; ``ValueError`` on any malformed clause."""
    if not text or not text.strip():
        return FaultPlan()
    faults = []
    for raw in text.split(";"):
        clause = raw.strip()
        if not clause:
            continue
        job = ""
        if "@" in clause:
            clause, _, tail = clause.partition("@")
            if not tail.startswith("job="):
                raise ValueError(
                    f"fault clause {raw!r}: expected '@job=ID', got {tail!r}")
            job = tail[len("job="):]
            if not job:
                raise ValueError(f"fault clause {raw!r}: empty job id")
        parts = clause.split(":")
        kind = parts[0]
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in {raw!r}; "
                             f"have {list(_KINDS)}")
        args, opts = [], {}
        for p in parts[1:]:
            if "=" in p:
                k, _, v = p.partition("=")
                if k != "times":
                    raise ValueError(
                        f"fault clause {raw!r}: unknown option {k!r}")
                opts["times"] = int(v)
            else:
                args.append(p)
        try:
            if kind == "slow-at-step":
                step, seconds = int(args[0]), float(args[1])
            else:
                (step,), seconds = (int(args[0]),), 0.0
                if len(args) != 1:
                    raise IndexError
        except (IndexError, ValueError) as e:
            if isinstance(e, ValueError):
                raise ValueError(f"fault clause {raw!r}: bad argument") from e
            want = "N:SECONDS" if kind == "slow-at-step" else "N"
            raise ValueError(
                f"fault clause {raw!r}: expected {kind}:{want}") from e
        times = opts.get("times", 1)
        if times < 1 or step < 0:
            raise ValueError(f"fault clause {raw!r}: step/times must be >= 0/1")
        faults.append(Fault(kind=kind, step=step, seconds=seconds,
                            times=times, job=job))
    return FaultPlan(faults=tuple(faults))


def plan_from_env(default: str = "") -> FaultPlan:
    """The plan in ``REPRO_FAULT_SPEC`` (falling back to ``default``)."""
    return parse_fault_spec(os.environ.get("REPRO_FAULT_SPEC", default))


def arm_torn_checkpoint(manager, *, at_step: int):
    """Wrap ``manager`` so its first save at ``step >= at_step`` is torn.

    The injected write produces exactly what a mid-write kill leaves
    behind: a partial ``step_*.tmp`` directory with no ``manifest.json``
    and no rename — then raises inside the (async) writer thread
    (:class:`repro_torch.checkpoint.CheckpointManager`'s ``_write``, the
    reference's signature). The
    manager's error capture must surface the exception on the next
    ``wait()``/``save()``, and ``latest_step()`` must keep resolving to the
    last *complete* checkpoint. Later saves go through untouched.
    """
    orig = manager._write
    fired = []

    def torn_write(step, host, meta):
        if not fired and step >= at_step:
            fired.append(step)
            tmp = os.path.join(manager.dir, f"step_{step:08d}.tmp")
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                f.write(b"torn")        # partial payload, no manifest
            raise OSError(f"injected torn checkpoint write at step {step}")
        return orig(step, host, meta)

    manager._write = torn_write
    return manager
