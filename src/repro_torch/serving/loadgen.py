"""Load generator: drive a :class:`~repro_torch.serving.server.SimServer` with a
request schedule and report throughput and latency tails.

Two arrival modes:

* **burst** (``rate_hz=0``) — submit everything up front, then drain. This
  measures the server's batching capacity: with K same-fingerprint
  requests and ``max_batch=B`` the scheduler runs ⌈K/B⌉ batches, and the
  per-request latencies include their queue wait.
* **paced** (``rate_hz>0``) — submit at a fixed open-loop rate against the
  *running* scheduler thread, the serving analogue of a steady request
  stream.

Backpressure is survived, not ignored: a submit rejected with
:class:`~repro_torch.serving.queue.QueueFullError` is retried up to
``max_submit_retries`` times with exponential backoff floored at the
queue's ``retry_after_hint`` (in burst mode a drain pass frees room first,
keeping tests deterministic); a request still rejected after the budget is
recorded as a structured :class:`~repro_torch.fleet.records.FailureRecord`
instead of silently dropping — a burst larger than ``max_pending`` no
longer loses requests without a trace.

The report carries per-request latencies (submit → final observable, queue
wait included), nearest-rank p50/p95/p99 tails, and requests/s over the
whole run.  Port of ``repro.serving.loadgen``; ``chip_smoke.py``'s
phase 10 reads these numbers on the card.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.fleet.records import FailureRecord
from repro_torch.serving.queue import QueueFullError
from repro_torch.serving.request import SimRequest, SimResult
from repro_torch.serving.server import SimServer


def percentile_us(latencies_us: list[float], frac: float) -> float:
    """Nearest-rank percentile (the ``tuning.timing.time_stats``
    convention), on an already-collected latency sample in µs."""
    if not latencies_us:
        return 0.0
    vals = sorted(latencies_us)
    rank = max(1, int(round(frac * len(vals) + 0.5)))
    return vals[min(rank, len(vals)) - 1]


@dataclasses.dataclass
class LoadReport:
    """Aggregate of one load-generator run."""

    results: list[SimResult]
    wall_s: float                   # first submit → last result
    rate_hz: float                  # requested arrival rate (0 = burst)
    rejected: list = dataclasses.field(default_factory=list)
    submit_retries: int = 0         # resubmissions after QueueFullError

    @property
    def n_requests(self) -> int:
        return len(self.results) + len(self.rejected)

    @property
    def n_failed(self) -> int:
        return sum(1 for r in self.results if not r.ok)

    @property
    def n_rejected(self) -> int:
        """Requests shed after exhausting the submit-retry budget."""
        return len(self.rejected)

    @property
    def requests_per_s(self) -> float:
        return self.n_requests / self.wall_s if self.wall_s > 0 else 0.0

    def latencies_us(self) -> list[float]:
        return [r.latency_s * 1e6 for r in self.results if r.ok]

    def stats(self) -> dict:
        """The bench-row payload: mean/p50/p95/p99 latency + throughput."""
        lat = self.latencies_us()
        mean = sum(lat) / len(lat) if lat else 0.0
        return {
            "n_requests": self.n_requests,
            "n_failed": self.n_failed,
            "n_rejected": self.n_rejected,
            "submit_retries": self.submit_retries,
            "requests_per_s": round(self.requests_per_s, 3),
            "mean_us": round(mean, 3),
            "p50_us": round(percentile_us(lat, 0.50), 3),
            "p95_us": round(percentile_us(lat, 0.95), 3),
            "p99_us": round(percentile_us(lat, 0.99), 3),
            "wall_s": round(self.wall_s, 6),
        }


def run_load(server: SimServer, requests: list[SimRequest], *,
             rate_hz: float = 0.0, max_submit_retries: int = 0,
             retry_backoff_s: float = 0.02) -> LoadReport:
    """Submit ``requests`` against ``server`` and wait for every result.

    Burst mode drains on the calling thread when no scheduler thread is
    running (deterministic for tests); paced mode starts the scheduler
    thread if needed and stops it again if this call started it.

    A :class:`QueueFullError` is retried up to ``max_submit_retries``
    times, sleeping ``max(hint, retry_backoff_s · 2^attempt)`` (capped at
    1 s) between tries — and, when no scheduler thread is draining, running
    one ``serve_pending()`` pass first so a retry can actually find room.
    Requests rejected after the budget land in ``LoadReport.rejected`` as
    :class:`FailureRecord`\\ s (kind ``rejected``).
    """
    started_here = False
    if rate_hz > 0 and not server.running:
        server.start()
        started_here = True
    t0 = time.monotonic()
    tickets = []
    rejected: list[FailureRecord] = []
    retries = 0
    for i, req in enumerate(requests):
        if rate_hz > 0 and i:
            # open-loop pacing against the schedule, not the previous send
            time.sleep(max(0.0, t0 + i / rate_hz - time.monotonic()))
        for attempt in range(max_submit_retries + 1):
            try:
                tickets.append(server.submit(req))
                break
            except QueueFullError as e:
                if attempt >= max_submit_retries:
                    rejected.append(FailureRecord(
                        kind="rejected", where="serving.queue",
                        job_id=req.request_id or f"req{i}", attempt=attempt,
                        detail=str(e), retryable=True, time_s=time.time()))
                    break
                retries += 1
                if not server.running:
                    server.serve_pending()    # free room deterministically
                time.sleep(min(max(e.retry_after_hint,
                                   retry_backoff_s * (2 ** attempt)), 1.0))
    if not server.running:
        server.serve_pending()
    results = [t.result() for t in tickets]
    wall = time.monotonic() - t0
    if started_here:
        server.stop()
    return LoadReport(results=results, wall_s=wall, rate_hz=rate_hz,
                      rejected=rejected, submit_retries=retries)
