"""Counters/gauges registry for wire-traffic and cache accounting.

Flat dot-separated string keys (``comm.exchange_rounds.data``,
``plan_cache.hits``), integer/float values. Counters accumulate with
:meth:`Metrics.inc`; gauges overwrite with :meth:`Metrics.set_gauge`.

Copy of ``repro.obs.metrics``.  The port has no tracing step: its
comm-layer counters fire each time an exchange runs, in the rank process
that runs it (one rank's view, as the reference's trace-time counters are
one shard's).  One forward transform counts what the reference counts
when it traces one.

Disabled, ``inc``/``set_gauge`` return before touching the lock or the
dict — instrumentation left in hot paths costs one branch.
"""

from __future__ import annotations

import threading

from repro_torch.obs import _state


class Metrics:
    """Thread-safe counters + gauges, cheap when disabled."""

    def __init__(self):
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._lock = threading.Lock()

    # ---- writers (no-ops while disabled) ---------------------------------
    def inc(self, name: str, value: float = 1) -> None:
        if not _state.is_enabled():
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def set_gauge(self, name: str, value: float) -> None:
        if not _state.is_enabled():
            return
        with self._lock:
            self._gauges[name] = value

    # ---- readers (always available) --------------------------------------
    def get(self, name: str, default: float = 0) -> float:
        with self._lock:
            if name in self._counters:
                return self._counters[name]
            return self._gauges.get(name, default)

    def counters(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def snapshot(self) -> dict:
        """``{"counters": {...}, "gauges": {...}}`` for exporters."""
        return {"counters": self.counters(), "gauges": self.gauges()}

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
