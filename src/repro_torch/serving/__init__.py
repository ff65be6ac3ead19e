"""``repro_torch.serving`` — the batched spectral-simulation serving layer.

Port of ``repro.serving``: from "request arrives" to "observables stream
back", the continuous-batching problem shape of LLM inference applied to
the FFT-cycle solvers of ``repro_torch.solvers``.  The pieces, each its
own module:

* :mod:`~repro_torch.serving.request` — the :class:`SimRequest` /
  :class:`SimResult` contract, the streamed :class:`StepUpdate` events,
  the requester's :class:`Ticket`, and :func:`request_key`, the batching
  fingerprint (the reference's, key for key);
* :mod:`~repro_torch.serving.queue` — :class:`RequestQueue`:
  per-fingerprint FIFO lanes, globally-fair batch selection,
  bounded-depth backpressure (:class:`QueueFullError`);
* :mod:`~repro_torch.serving.registry` — :class:`EngineRegistry`: one
  live solver per fingerprint, with tuned plans reused from the
  ``repro_torch.tuning`` plan cache;
* :mod:`~repro_torch.serving.server` — :class:`SimServer`: the scheduling
  loop that advances each admitted batch as **one solver step over a
  leading lane axis** (``SpectralSolver.batched_step``: each kernel launch
  covers every lane) and streams per-step observables back per lane,
  bitwise a solo run's; on a grid of rank processes rank 0 schedules and
  every rank steps;
* :mod:`~repro_torch.serving.loadgen` — :func:`run_load` /
  :class:`LoadReport`: burst and paced arrival schedules with requests/s
  and p50/p95/p99 latency tails.

``python -m repro_torch.serving.cli`` (or ``python -m
repro_torch.launch.serve --sim``) drives a server from the command line.
"""

from __future__ import annotations

from repro_torch.fleet.records import FailureRecord
from repro_torch.serving.loadgen import LoadReport, percentile_us, run_load
from repro_torch.serving.queue import QueueFullError, RequestQueue
from repro_torch.serving.registry import EngineRegistry
from repro_torch.serving.request import (SimRequest, SimResult, StepUpdate, Ticket,
                                         request_key)
from repro_torch.serving.server import SimServer, scaled_initial_fields

__all__ = [
    "SimRequest", "SimResult", "StepUpdate", "Ticket", "request_key",
    "RequestQueue", "QueueFullError", "EngineRegistry", "SimServer",
    "scaled_initial_fields", "run_load", "LoadReport", "percentile_us",
    "FailureRecord",
]
