"""``repro_torch.obs`` — tracing and metrics, zero overhead when disabled.

Copy of ``repro.obs`` (which imports no jax; the port keeps its own copy
and imports nothing of ``repro``).  A thread-safe span :class:`Tracer`
(nested ``with obs.span(name, **attrs)`` contexts, Chrome-trace-event
export for Perfetto), a counters/gauges :class:`Metrics` registry, and
the :func:`traced_call` entry-point wrapper.  Instrumented, with the
reference's names: ``core.transpose`` and ``kernels.ring_rdma`` (the wire
counters ``comm.exchanges.<axis>``, ``comm.exchange_rounds.<axis>``,
``comm.<kind>_dispatches``, ``comm.wire_bytes``), ``core.comm``
(``comm.engine_exchange_rounds.<engine>``), ``core.fft3d`` (``trace/fft3d.*``
phase spans with the perf model's ``model_wire_us``,
``dispatch/fft3d.fwd``/``.inv`` with its ``model_predicted_us``),
``solvers.base`` (``dispatch/solver.step`` with ``model_predicted_us``,
``dispatch/solver.observables``), ``tuning`` (``tune/...`` spans,
``tuning.candidates_timed``, ``plan_cache.hits``/``misses``) and
``checkpoint`` (``checkpoint.*``).

What differs from the reference: there is no jit.  Counters count each
exchange as it runs, per rank process; a ``dispatch/...`` span waits for
the card (``torch.cuda.synchronize``) before it closes; a ``trace/...``
span times the host's launches of a phase and waits for nothing.

Disabled — the default — every entry point returns before allocating:
``span()`` hands back a shared no-op singleton, ``metrics.inc`` is one
branch, ``traced_call`` wrappers tail-call straight through.  Enable with
:func:`enable` (the solver CLI's ``--trace PATH`` does), export with
:func:`write_chrome_trace` / :func:`summary_table`.
"""

from __future__ import annotations

from repro_torch.obs import _state
from repro_torch.obs.export import (chrome_trace, summary_table,
                                    validate_chrome_trace, write_chrome_trace)
from repro_torch.obs.metrics import Metrics
from repro_torch.obs.tracer import (NULL_SPAN, Span, TracedCallable, Tracer,
                                   synchronize)

__all__ = [
    "Tracer", "Span", "TracedCallable", "Metrics", "NULL_SPAN",
    "tracer", "metrics", "span", "traced_call",
    "enable", "disable", "is_enabled", "clear", "capture",
    "chrome_trace", "write_chrome_trace", "validate_chrome_trace",
    "summary_table", "synchronize",
]

#: process-wide default instances every instrumented module shares
tracer = Tracer()
metrics = Metrics()

is_enabled = _state.is_enabled


def enable() -> None:
    """Turn span/metric collection on (process-wide)."""
    _state.set_enabled(True)


def disable() -> None:
    """Turn collection off; recorded spans/counters stay readable."""
    _state.set_enabled(False)


def clear() -> None:
    """Drop all recorded spans and counters."""
    tracer.clear()
    metrics.clear()


def span(name: str, /, **attrs):
    """``with obs.span("dispatch/fft3d.fwd", engine="torus"):`` on the
    default tracer. Returns the shared no-op singleton while disabled —
    guard ``**attrs`` construction behind :func:`is_enabled` on hot paths,
    since keyword packing allocates before the call."""
    return tracer.span(name, **attrs)


def traced_call(fn, name: str, attrs: dict | None = None) -> TracedCallable:
    """Wrap ``fn`` so every call is a ``dispatch/...`` span that waits for
    the card before it closes.  Attributes are fixed at wrap time; other
    attributes of ``fn`` forward through."""
    return TracedCallable(fn, name, tracer, attrs)


class capture:
    """``with obs.capture() as (tracer, metrics):`` — enable + clear on
    entry, disable on exit (events stay readable). Test/tooling helper."""

    def __enter__(self):
        clear()
        enable()
        return tracer, metrics

    def __exit__(self, *exc):
        disable()
        return False
