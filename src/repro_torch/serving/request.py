"""The serving contract: ``SimRequest`` in, streamed ``StepUpdate``s and a
``SimResult`` out.

Port of ``repro.serving.request``: the same contract and the same
fingerprint, so one request gets one :func:`request_key` in both packages.

A :class:`SimRequest` names one simulation to run — a registered
``repro_torch.solvers`` case, its grid extent, dtype, physics parameters, how
many Δt steps to advance, and optionally an explicit FFT-plan config. The
server answers with a :class:`Ticket` whose event stream carries one
:class:`StepUpdate` per time step (the case's grid-reduced observables,
exactly what a solo ``SpectralSolver.run`` would record) and terminates
with a :class:`SimResult`.

**Batching semantics.** Requests are grouped by :func:`request_key` — the
canonical fingerprint of everything that shapes the *compiled step*:
``(case, n, dtype, params, plan_cfg)``. Same-key requests are batched into
one solver step over a leading lane axis
(``SpectralSolver.batched_step``); they may differ only in the per-request
knobs that don't enter the fingerprint: ``steps`` (how far to run),
``scale`` (the initial-condition amplitude), and ``request_id``. Two
requests that spell the same physics differently (one passing a default
explicitly) get different keys and simply don't batch — correct, just less
shared work.

Fingerprinting is pure hashing, so the queue can group requests without
touching device state.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import queue as _queue
import time
from typing import Any


@dataclasses.dataclass(frozen=True)
class SimRequest:
    """One simulation to serve.

    ``case``/``n``/``dtype``/``params``/``plan_cfg`` identify the compiled
    engine (they form the batching fingerprint); ``steps``, ``scale`` and
    ``request_id`` are per-request and batch freely.
    """

    case: str                       # registered repro_torch.solvers case name
    n: Any                          # cubic extent N or (nx, ny, nz)
    steps: int                      # Δt steps to advance (≥ 0)
    dtype: str = "float32"
    params: dict = dataclasses.field(default_factory=dict)   # physics kwargs
    plan_cfg: dict | None = None    # explicit FFT-plan knobs; None = registry
    scale: float = 1.0              # initial-condition amplitude multiplier
    request_id: str = ""            # caller's label, echoed in the result

    def shape(self) -> tuple[int, int, int]:
        n = self.n
        return (n, n, n) if isinstance(n, int) else tuple(int(d) for d in n)


def request_key(req: SimRequest) -> str:
    """Canonical batching fingerprint of a request's compiled engine.

    Hashes the step-shaping fields only — ``steps``/``scale``/``request_id``
    never enter, so requests differing only there share one compiled
    engine and batch together. ``plan_cfg`` is normalized through the
    tuning layer's legacy-knob mapping first (``net`` → ``comm_engine``)
    so equivalent spellings collide onto one key.
    """
    import numpy as np

    cfg = None
    if req.plan_cfg is not None:
        from repro_torch.tuning.space import normalize_config
        cfg = normalize_config(req.plan_cfg)
        cfg.pop("net", None)        # folded into comm_engine by normalize
        cfg = {k: cfg[k] for k in sorted(cfg)}
    nx, ny, nz = req.shape()
    payload = {
        "case": str(req.case),
        "n": [nx, ny, nz],
        "dtype": np.dtype(req.dtype).name,
        "params": {k: req.params[k] for k in sorted(req.params)},
        "plan_cfg": cfg,
    }
    digest = hashlib.sha256(
        json.dumps(payload, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]
    return f"{payload['case']}_n{nx}x{ny}x{nz}_{payload['dtype']}_{digest}"


@dataclasses.dataclass(frozen=True)
class StepUpdate:
    """One streamed time step: the observables a solo run would record."""

    step: int                       # 0 = the t=0 diagnostics
    t: float
    observables: dict               # {name: float}, "t" included


@dataclasses.dataclass
class SimResult:
    """Terminal event of a ticket's stream."""

    request: SimRequest
    fingerprint: str
    history: list                   # observables per step (len = steps + 1)
    batch_size: int = 1             # lanes in the batch that served this
    submitted_s: float = 0.0        # monotonic clocks for latency accounting
    finished_s: float = 0.0
    error: str = ""                 # non-empty = the batch failed

    @property
    def ok(self) -> bool:
        return not self.error

    @property
    def latency_s(self) -> float:
        """Submit → final-observable wall time (queue wait included)."""
        return max(self.finished_s - self.submitted_s, 0.0)


class Ticket:
    """The requester's handle: a thread-safe stream of per-step events.

    The scheduler thread pushes :class:`StepUpdate`s as the batch advances
    and a :class:`SimResult` last; the submitting thread consumes them with
    :meth:`updates` (a generator that ends when the result arrives) or
    blocks straight on :meth:`result`.
    """

    def __init__(self, request: SimRequest, fingerprint: str, seq: int):
        self.request = request
        self.fingerprint = fingerprint
        self.seq = seq                       # global arrival order
        self.submitted_s = time.monotonic()
        self._events: _queue.Queue = _queue.Queue()
        self._result: SimResult | None = None

    # -- scheduler side ----------------------------------------------------
    def _push(self, event) -> None:
        self._events.put(event)

    # -- requester side ----------------------------------------------------
    def updates(self, timeout: float | None = None):
        """Yield :class:`StepUpdate`s until the terminal result arrives.

        ``timeout`` bounds the wait for *each* event; ``queue.Empty``
        propagates when the server stops feeding the stream in time.
        """
        while self._result is None:
            event = self._events.get(timeout=timeout)
            if isinstance(event, SimResult):
                self._result = event
                return
            yield event

    def result(self, timeout: float | None = None) -> SimResult:
        """Drain the stream and return the terminal :class:`SimResult`."""
        for _ in self.updates(timeout=timeout):
            pass
        assert self._result is not None
        return self._result

    @property
    def done(self) -> bool:
        return self._result is not None
