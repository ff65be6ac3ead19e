"""Shared on/off switch of the observability layer.

Copy of ``repro.obs._state``.  One module-level flag, imported by
``obs.tracer`` and ``obs.metrics`` alike (keeping it here avoids a tracer
<-> metrics import cycle).  The flag is the zero-overhead-when-disabled
contract: every instrumented call site checks it *before* allocating
attributes, formatting counter keys, or taking a lock, so a disabled
tracer costs one branch per instrumented call.
"""

from __future__ import annotations

import threading

#: guards the enable/disable transitions (readers go lock-free: a stale read
#: during a transition only means one span more or less, never corruption)
lock = threading.RLock()

_enabled = False


def is_enabled() -> bool:
    """Whether tracing/metrics collection is currently on."""
    return _enabled


def set_enabled(value: bool) -> None:
    global _enabled
    with lock:
        _enabled = bool(value)
