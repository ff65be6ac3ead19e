"""The request queue: fingerprint-grouped batching with global FIFO
fairness and bounded-depth backpressure.

Copy of ``repro.serving.queue`` (pure Python), on ``repro_torch.obs``.

Pending tickets live in per-fingerprint FIFO lanes. A scheduling round
(:meth:`RequestQueue.next_batch`) picks the lane whose *head* is the
oldest request in the whole queue — so no fingerprint can starve another:
groups are served in arrival order of their oldest member — and drains up
to ``max_batch`` tickets from it in arrival order. Everything popped
together shares one compiled engine and becomes one leading-batch-axis
solver step.

Backpressure is a hard depth bound: when ``max_pending`` is set, a submit
that would exceed it raises :class:`QueueFullError` immediately (the
caller sheds load or retries; nothing blocks inside the scheduler). The
rejection carries a ``retry_after_hint`` — the queue's advice, in seconds,
on when a retry might find room (scaled by how overfull the queue is);
the load generator's bounded retry loop honors it.

Gauges: ``serving.queue_depth`` tracks the pending count on every submit
and every batch pull; ``serving.requests.rejected`` counts shed load.
"""

from __future__ import annotations

import collections
import threading

from repro_torch import obs
from repro_torch.serving.request import Ticket


class QueueFullError(RuntimeError):
    """Submit refused: the queue is at its ``max_pending`` depth bound.

    ``retry_after_hint`` (seconds) is the queue's advice on when to retry:
    a base hint scaled by the relative overfullness at rejection time.
    Purely advisory — the queue promises nothing about future depth."""

    def __init__(self, msg: str, retry_after_hint: float = 0.05):
        super().__init__(msg)
        self.retry_after_hint = float(retry_after_hint)


class RequestQueue:
    """Thread-safe pending-request store with fingerprint lanes."""

    def __init__(self, max_pending: int | None = None,
                 retry_hint_s: float = 0.05):
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = max_pending
        self.retry_hint_s = float(retry_hint_s)
        self._lanes: dict[str, collections.deque[Ticket]] = {}
        self._depth = 0
        self._lock = threading.Lock()

    def submit(self, ticket: Ticket) -> None:
        """Append to the ticket's fingerprint lane (FIFO within the lane)."""
        with self._lock:
            if self.max_pending is not None and self._depth >= self.max_pending:
                obs.metrics.inc("serving.requests.rejected")
                hint = self.retry_hint_s * (self._depth / self.max_pending)
                raise QueueFullError(
                    f"queue at max_pending={self.max_pending} "
                    f"({self._depth} pending)", retry_after_hint=hint)
            self._lanes.setdefault(ticket.fingerprint,
                                   collections.deque()).append(ticket)
            self._depth += 1
            depth = self._depth
        obs.metrics.set_gauge("serving.queue_depth", depth)

    def next_batch(self, max_batch: int) -> list[Ticket]:
        """Up to ``max_batch`` same-fingerprint tickets, oldest lane first.

        Empty list when nothing is pending. The selected lane is the one
        holding the globally oldest ticket (min arrival ``seq`` over lane
        heads); tickets pop in arrival order.
        """
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        with self._lock:
            if not self._lanes:
                return []
            fp = min(self._lanes, key=lambda k: self._lanes[k][0].seq)
            lane = self._lanes[fp]
            batch = [lane.popleft() for _ in range(min(max_batch, len(lane)))]
            if not lane:
                del self._lanes[fp]
            self._depth -= len(batch)
            depth = self._depth
        obs.metrics.set_gauge("serving.queue_depth", depth)
        return batch

    @property
    def depth(self) -> int:
        """Total pending tickets across all lanes."""
        with self._lock:
            return self._depth

    def lanes(self) -> dict[str, int]:
        """{fingerprint: pending count} snapshot."""
        with self._lock:
            return {fp: len(lane) for fp, lane in self._lanes.items()}
