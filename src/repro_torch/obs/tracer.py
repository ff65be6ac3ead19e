"""Thread-safe span tracer with nesting, for Chrome-trace-event export.

Copy of ``repro.obs.tracer``; :class:`TracedCallable` waits for the card
instead of a jit dispatch.  A :class:`Tracer` records *spans* — named
wall-clock intervals with key/value attributes — via the
``with tracer.span(name, **attrs):`` context manager. Spans nest per
thread (each records its parent's name and depth), and the recorded
events serialize straight into the Chrome trace event format
(``obs.export.chrome_trace``) that Perfetto / chrome://tracing load.

Two span flavors by naming convention, the reference's names:

* ``dispatch/...`` — wall time of an entry point's call.  CUDA runs
  asynchronously, so the span waits for the card before it closes
  (:func:`traced_call` and ``SpectralSolver.step`` do);
* ``trace/...`` — the host's launches of one phase of a transform (the fold
  phases of ``core.fft3d``).  It does not wait for the card: on CUDA it
  times the launches, on the CPU the work.

Disabled (the default), ``tracer.span(name)`` returns a module-level no-op
singleton — no event, no allocation, no lock.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

import torch

from repro_torch.obs import _state


def _now_us() -> float:
    return time.perf_counter() * 1e6


class _NullSpan:
    """The shared disabled-path span: enter/exit do nothing, allocate
    nothing. ``set_attr`` is accepted and dropped so call sites need no
    enabled-check of their own around attribute updates."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of the tensors in ``out`` (nested tuples, lists
    and dict values)."""
    if isinstance(out, (tuple, list)):
        for o in out:
            _cuda_devices(o, found)
    elif isinstance(out, dict):
        for o in out.values():
            _cuda_devices(o, found)
    elif getattr(out, "is_cuda", False):
        found.add(out.device)
    return found


def synchronize(out) -> None:
    """Wait for the work behind the CUDA tensors in ``out``: one
    ``torch.cuda.synchronize`` per device they lie on; nothing for CPU
    tensors (or anything else)."""
    for d in _cuda_devices(out, set()):
        torch.cuda.synchronize(d)


class Span:
    """One live span (context manager). Created only when tracing is on."""

    __slots__ = ("tracer", "name", "attrs", "t0_us", "tid", "parent", "depth")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0_us = 0.0
        self.tid = 0
        self.parent = ""
        self.depth = 0

    def set_attr(self, **attrs) -> None:
        """Attach/overwrite attributes while the span is open (e.g. a
        result computed inside the ``with`` block)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = self.tracer._stack()
        self.parent = stack[-1].name if stack else ""
        self.depth = len(stack)
        self.tid = threading.get_ident()
        stack.append(self)
        self.t0_us = _now_us()
        return self

    def __exit__(self, *exc):
        dur = _now_us() - self.t0_us
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self.tracer._record({
            "name": self.name, "ts": self.t0_us, "dur": dur,
            "tid": self.tid, "parent": self.parent, "depth": self.depth,
            "args": self.attrs,
        })
        return False


class Tracer:
    """Collects span events; thread-safe; cheap when disabled."""

    def __init__(self):
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)

    def span(self, name: str, /, **attrs):
        """Context manager timing one named interval. Returns the shared
        no-op singleton when tracing is disabled (zero allocation as long
        as the caller passes no ``**attrs`` — guard attribute construction
        behind ``obs.is_enabled()`` on hot paths)."""
        if not _state.is_enabled():
            return NULL_SPAN
        return Span(self, name, attrs)

    def events(self) -> list[dict]:
        """Snapshot of the recorded span events (closed spans only)."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


class TracedCallable:
    """A callable wrapped in a ``dispatch/...`` span that waits for the
    card before the span closes: CUDA work is asynchronous, and without the
    wait the span would time only the host's launches.  Disabled, the
    wrapper is one branch and a tail call.

    Attribute access forwards to the wrapped function.
    """

    def __init__(self, fn: Callable, name: str, tracer: "Tracer",
                 attrs: dict | None = None):
        self._fn = fn
        self._name = name
        self._tracer = tracer
        self._attrs = dict(attrs or {})

    def __call__(self, *args, **kwargs) -> Any:
        if not _state.is_enabled():
            return self._fn(*args, **kwargs)
        with self._tracer.span(self._name, **self._attrs):
            out = self._fn(*args, **kwargs)
            synchronize(out)
        return out

    def __getattr__(self, item):
        return getattr(self._fn, item)

    def __repr__(self):
        return f"TracedCallable({self._name!r}, {self._fn!r})"
