"""``repro_torch.fleet`` — the port of ``repro.fleet``: fault-tolerant
orchestration of solver ensembles.

One process per *worker*, many workers per *campaign*, and a controller
that assumes workers die.  The pieces, each its own module, with the
reference's names:

* :mod:`~repro_torch.fleet.records` — :class:`FailureRecord`, the
  structured failure type the controller, ``repro_torch.serving`` and the
  reports share, plus the worker exit-code conventions.
* :mod:`~repro_torch.fleet.faults` — deterministic fault injection
  (``kill-at-step`` / ``torn-checkpoint`` / ``slow-at-step``), parsed from
  ``REPRO_FAULT_SPEC`` / ``--inject`` and keyed on (job, attempt, step).
* :mod:`~repro_torch.fleet.worker` — the supervised unit: one solver job
  with periodic checkpoints on its ``device``, in the worker process on
  1×1 or in its rank processes (:func:`repro_torch.dist.run_ranks`),
  resuming from the latest complete snapshot (possibly on another grid).
* :mod:`~repro_torch.fleet.controller` — :class:`FleetController`: pack
  jobs onto a pool of rank-process slots, supervise the workers, classify
  deaths (crash / timeout / poison), retry from checkpoint with capped
  exponential backoff, quarantine exhausted jobs without wedging the
  campaign.
* :mod:`~repro_torch.fleet.cli` — ``python -m repro_torch.fleet.cli``.

The headline invariant, as in the reference (``tests/test_torch_fleet_restart.py``
on the CPU, ``chip_smoke.py``'s fleet phase on the card): a campaign with an
injected worker kill produces per-job observable histories identical to
the same campaign run unkilled, and a job whose retry budget is exhausted
is quarantined while its siblings complete.

Importing this package touches no card; only workers do.
"""

from __future__ import annotations

from repro_torch.fleet.controller import FleetController, FleetJob, JobResult
from repro_torch.fleet.faults import (Fault, FaultPlan, arm_torn_checkpoint,
                                      parse_fault_spec)
from repro_torch.fleet.records import (KILL_EXIT, POISON_EXIT, FailureRecord,
                                       classify_exit)

__all__ = [
    "FleetController", "FleetJob", "JobResult",
    "Fault", "FaultPlan", "parse_fault_spec", "arm_torn_checkpoint",
    "FailureRecord", "classify_exit", "KILL_EXIT", "POISON_EXIT",
]
