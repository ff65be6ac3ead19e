"""The serving loop: admit a same-fingerprint batch, advance it as one
solver step per Δt, stream each lane's observables back to its requester.

Port of ``repro.serving.server``.  :class:`SimServer` ties the layer
together.  ``submit(request)`` returns a
:class:`~repro_torch.serving.request.Ticket` immediately (or raises
:class:`~repro_torch.serving.queue.QueueFullError` under backpressure); a
scheduling round pulls the oldest fingerprint lane from the queue, fetches
that shape's solver from the
:class:`~repro_torch.serving.registry.EngineRegistry`, stacks the lanes'
initial fields along a leading lane axis, and then steps the whole batch
through ``SpectralSolver.batched_step``: one pass of the step's kernels a
Δt, however many requests ride in it.  After every step each lane's
observables are fanned out as ``StepUpdate``s, so requesters see their
trajectory live, not at the end.

**Identity guarantee**: a lane's streamed history is exactly what a solo
``SpectralSolver`` run of the same request computes: the batched step
runs the case's own step on the stack (each kernel transforms its rows
independently), the observables reduce each lane's own view, and the
clocks accumulate identically.

**Run-to-longest batching**: lanes whose ``steps`` differ batch together;
the batch advances ``max(steps)`` times and a lane stops receiving updates
(and gets its result) once its own horizon is reached.

**On a grid of rank processes** (:func:`repro_torch.dist.run_ranks`)
rank 0 holds the scheduler: the queue, the tickets and the threaded mode.
For each admitted batch it broadcasts ``(fingerprint, requests)`` to every
rank (``broadcast_object_list`` over the world group); every rank takes
the solver from its own registry, stacks its block of each lane's initial
fields and runs the same steps (:meth:`SimServer.follow` on the ranks
other than 0).  The observables are all-reduced, so rank 0 has every
lane's.  A refusal or exception before the first exchange is all-reduced
and every rank fails that batch together; one raised during the steps
leaves the ranks out of step, so after failing the batch's lanes rank 0
raises it.  :meth:`SimServer.close` on rank 0 ends the other ranks'
``follow()``.

The server runs synchronously (``serve_pending()`` drains the queue on
the caller's thread) or threaded (``start()`` spawns a scheduler thread
that wakes on submit and makes the server's CUDA device its own).  Spans:
``serve/admit`` around an admission and ``dispatch/serving.batch_step``
around each batched step (which waits for the card); counters and gauges
``serving.*``, as in the reference.
"""

from __future__ import annotations

import collections
import threading
import time

import torch
import torch.distributed as tdist

from repro_torch import dist, obs
from repro_torch.device import resolve_device
from repro_torch.fleet.records import FailureRecord
from repro_torch.serving.queue import RequestQueue
from repro_torch.serving.registry import EngineRegistry
from repro_torch.serving.request import (SimRequest, SimResult, StepUpdate, Ticket,
                                         request_key)


def scaled_initial_fields(solver, scale: float) -> tuple:
    """The solver's t=0 fields with the request's amplitude applied.

    The one definition both the server and the solo-reference checks use,
    so "batched ≡ solo" compares identical initial conditions.
    """
    fields = solver.initial_fields()
    if scale == 1.0:
        return fields
    return tuple(a * scale for a in fields)


class SimServer:
    """Batched spectral-simulation server on one grid and device."""

    def __init__(self, grid, *, device="cuda", max_batch: int = 8,
                 max_pending: int | None = None,
                 registry: EngineRegistry | None = None,
                 use_plan_cache: bool = True,
                 cache_path: str | None = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.grid = dist.bind_grid(grid, "serving.SimServer")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.ranked = self.grid.p > 1
        self.rank = dist.context().rank if self.ranked else 0
        self.max_batch = max_batch
        self.registry = registry or EngineRegistry(
            self.grid, device=dev, use_plan_cache=use_plan_cache,
            cache_path=cache_path)
        self.queue = RequestQueue(max_pending)
        # per-lane failure trail, same structured type the fleet uses
        # (bounded: serving failures are diagnostics, not campaign state)
        self.failures: collections.deque[FailureRecord] = collections.deque(
            maxlen=256)
        #: (fingerprint, request ids) of every batch this rank served
        self.batch_log: list[tuple[str, tuple]] = []
        self._seq = 0
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._closed = False

    def _scheduler(self, who: str) -> None:
        if self.rank != 0:
            raise RuntimeError(f"SimServer.{who}: rank {self.rank} follows rank "
                               "0's batches (SimServer.follow)")

    # ---- submission ------------------------------------------------------
    def submit(self, req: SimRequest) -> Ticket:
        """Enqueue; returns the requester's streaming ticket immediately."""
        self._scheduler("submit")
        if req.steps < 0:
            raise ValueError(f"steps must be >= 0, got {req.steps}")
        fp = request_key(req)
        with self._lock:
            self._seq += 1
            ticket = Ticket(req, fp, self._seq)
        self.queue.submit(ticket)          # raises QueueFullError when full
        obs.metrics.inc("serving.requests.submitted")
        self._wake.set()
        return ticket

    # ---- scheduling rounds ----------------------------------------------
    def serve_once(self) -> int:
        """Admit and run one batch; returns the number of requests served."""
        self._scheduler("serve_once")
        batch = self.queue.next_batch(self.max_batch)
        if not batch:
            return 0
        fp, reqs = batch[0].fingerprint, [t.request for t in batch]
        if self.ranked:
            self._broadcast(("batch", fp, reqs))
        self._serve_batch(fp, reqs, batch)
        return len(batch)

    def serve_pending(self) -> int:
        """Drain the queue on the calling thread; total requests served."""
        total = 0
        while True:
            served = self.serve_once()
            if not served:
                return total
            total += served

    def follow(self) -> int:
        """On a rank other than 0: serve the batches rank 0 broadcasts until
        it closes; returns the number of batches served."""
        if self.rank == 0:
            raise RuntimeError("SimServer.follow runs on the ranks other than 0")
        served = 0
        while True:
            msg = self._broadcast(None)
            if msg[0] == "stop":
                return served
            _, fp, reqs = msg
            self._serve_batch(fp, reqs, None)
            served += 1

    def close(self) -> None:
        """Stop serving (draining what is queued); on a grid, end the other
        ranks' :meth:`follow`.  Rank 0 only; idempotent."""
        self._scheduler("close")
        self.stop(drain=True)
        if self.ranked and not self._closed:
            self._broadcast(("stop",))
        self._closed = True

    @staticmethod
    def _broadcast(msg):
        """Rank 0's ``msg`` on every rank (the world gloo group)."""
        box = [msg]
        tdist.broadcast_object_list(box, src=0)
        return box[0]

    def _serve_batch(self, fp: str, reqs: list, tickets) -> None:
        """Admit and step one batch (every rank); ``tickets`` (rank 0) get
        the streamed updates and results."""
        nbatch = len(reqs)
        self.batch_log.append((fp, tuple(r.request_id for r in reqs)))
        err = ""
        try:
            with obs.span("serve/admit", fingerprint=fp, case=reqs[0].case,
                          batch=nbatch) if obs.is_enabled() else obs.NULL_SPAN:
                solver = self.registry.get(reqs[0], fingerprint=fp)
                lanes = [scaled_initial_fields(solver, r.scale) for r in reqs]
                stacked = tuple(torch.stack(xs) for xs in zip(*lanes))
                del lanes
        except Exception as e:  # refused before any exchange
            err = f"{type(e).__name__}: {e}"
        if self.ranked:
            failed = dist.all_reduce(torch.tensor(float(bool(err))), "max")
            if float(failed) and not err:
                err = "RuntimeError: the batch failed on another rank"
        if err:
            self._fail(tickets, fp, nbatch, err)
            return
        obs.metrics.inc("serving.batches")
        obs.metrics.inc("serving.requests.admitted", nbatch)
        obs.metrics.set_gauge("serving.batch_size", nbatch)
        try:
            self._step_batch(solver, stacked, fp, reqs, tickets)
        except Exception as e:
            self._fail(tickets, fp, nbatch, f"{type(e).__name__}: {e}")
            if self.ranked:  # the ranks are out of step: stop the grid
                raise

    def _fail(self, tickets, fp: str, nbatch: int, err: str) -> None:
        """Fail every lane loudly (rank 0 holds the tickets); keep serving."""
        obs.metrics.inc("serving.batches_failed")
        now = time.monotonic()
        wall = time.time()
        for t in tickets or ():
            self.failures.append(FailureRecord(
                kind="batch_error", where="serving.batch",
                job_id=t.request.request_id or fp, detail=err,
                retryable=False, time_s=wall))
            obs.metrics.inc("serving.requests.failed")
            t._push(SimResult(request=t.request, fingerprint=fp,
                              history=[], batch_size=nbatch,
                              submitted_s=t.submitted_s, finished_s=now,
                              error=err))

    def _step_batch(self, solver, stacked, fp: str, reqs: list, tickets) -> None:
        nbatch = len(reqs)
        histories: list[list] = [[] for _ in reqs]
        open_lanes = set(range(nbatch)) if tickets else set()

        def emit(step: int, t: float) -> None:
            # each lane's observables (collective on a grid), fanned out
            batched = solver.batched_observables(stacked)
            for i in sorted(open_lanes):
                o = {k: v[i] for k, v in batched.items()}
                o["t"] = t
                histories[i].append(o)
                tickets[i]._push(StepUpdate(step=step, t=t, observables=o))
                if step >= reqs[i].steps:
                    self._finish(tickets[i], histories[i], nbatch)
                    open_lanes.discard(i)

        t = 0.0
        emit(0, t)
        steps_max = max(r.steps for r in reqs)
        for step in range(1, steps_max + 1):
            if obs.is_enabled():
                with obs.span("dispatch/serving.batch_step", case=reqs[0].case,
                              batch=nbatch, step=step, fingerprint=fp):
                    stacked = solver.batched_step(stacked)
                    obs.synchronize(stacked)
            else:
                stacked = solver.batched_step(stacked)
            t = t + solver.dt             # same accumulation as solo step()
            emit(step, t)
        assert not open_lanes

    def _finish(self, ticket: Ticket, history: list, nbatch: int) -> None:
        obs.metrics.inc("serving.requests.completed")
        ticket._push(SimResult(
            request=ticket.request, fingerprint=ticket.fingerprint,
            history=history, batch_size=nbatch,
            submitted_s=ticket.submitted_s, finished_s=time.monotonic()))

    # ---- threaded mode ---------------------------------------------------
    def start(self) -> None:
        """Spawn the scheduler thread (idempotent)."""
        self._scheduler("start")
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="sim-serve", daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the scheduler thread; ``drain`` serves what's queued first."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if drain:
            self.serve_pending()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _loop(self) -> None:
        if self.device.type == "cuda":  # a new thread starts on card 0
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            if not self.serve_once():
                self._wake.wait(timeout=0.05)
                self._wake.clear()
