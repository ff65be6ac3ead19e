"""Structured failure records — the one vocabulary every supervisor speaks.

Copy of ``repro.fleet.records`` (which imports no jax; the port keeps its
own copy and imports nothing of ``repro``).

A :class:`FailureRecord` is what survives a failure: the fleet controller
attaches one to a job for every worker death (crash / timeout / poison
config), ``repro_torch.serving`` records one per failed batch lane and per
finally-rejected load-generator submission, and the fleet report JSON
serializes them verbatim. Keeping the type here — jax-free, import-cheap —
lets the queue, the server, the controller and the tests share one schema
instead of four ad-hoc dicts.

Worker exit-code conventions (the controller's classification inputs):

* ``POISON_EXIT`` (4)  — the job *spec* is invalid (unknown case, grid not
  divisible by the submesh, bad physics kwargs). Deterministic: retrying
  cannot help, so the controller quarantines immediately.
* ``KILL_EXIT`` (13)   — the fault injector's hard kill (``os._exit``),
  indistinguishable from a real preemption on purpose: classified
  ``crash`` and retried like one.
* anything else nonzero — ``crash`` (retryable); a supervisor-initiated
  kill after the deadline is classified ``timeout`` (retryable) by the
  controller itself, not from the exit code.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

#: worker exits with this when the job spec itself is invalid (never retry)
POISON_EXIT = 4
#: the fault injector's hard-kill exit code (retryable, like any crash)
KILL_EXIT = 13


@dataclasses.dataclass(frozen=True)
class FailureRecord:
    """One observed failure, structured for reports and retry decisions."""

    kind: str                   # crash | timeout | poison | batch_error | rejected
    where: str                  # component: "fleet.worker" | "serving.batch" | ...
    job_id: str                 # fleet job id / serving request id
    attempt: int = 0            # 0-based attempt index when it happened
    detail: str = ""            # human-readable cause (exception, log tail)
    exit_code: int | None = None
    retryable: bool = True      # may a supervisor reschedule after this?
    time_s: float = 0.0         # wall-clock (time.time()) of classification

    KINDS: ClassVar[frozenset] = frozenset(
        {"crash", "timeout", "poison", "batch_error", "rejected"})

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown failure kind {self.kind!r}; "
                             f"have {sorted(self.KINDS)}")

    def to_dict(self) -> dict:
        """JSON-serializable form (the fleet report embeds these)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FailureRecord":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def classify_exit(returncode: int) -> tuple[str, bool]:
    """``(kind, retryable)`` for a dead worker's exit code.

    The controller calls this for any nonzero return; timeouts never reach
    here (the supervisor kills and classifies those itself).
    """
    if returncode == POISON_EXIT:
        return "poison", False
    return "crash", True
