"""Exporters: Chrome-trace-event JSON (Perfetto-loadable) + summary table.

Copy of ``repro.obs.export``.

The JSON document follows the Chrome trace event format's "X" (complete)
events — ``name``/``ph``/``ts``/``dur``/``pid``/``tid``/``args`` under a
top-level ``traceEvents`` list — which https://ui.perfetto.dev and
``chrome://tracing`` both open directly. Extra top-level keys (our
``metrics`` snapshot and ``meta``) are tolerated by both viewers.
"""

from __future__ import annotations

import json
import os


def chrome_trace(tracer, metrics=None, meta: dict | None = None) -> dict:
    """Render recorded spans (+ the metrics snapshot) as one Chrome-trace
    document. Span attributes become the event's ``args``; the recorded
    parent/depth ride along in ``args`` too (Perfetto nests same-tid "X"
    events by time containment on its own)."""
    pid = os.getpid()
    events = []
    for ev in tracer.events():
        args = dict(ev.get("args") or {})
        if ev.get("parent"):
            args["parent"] = ev["parent"]
        events.append({
            "name": ev["name"], "ph": "X", "cat": ev["name"].split("/")[0],
            "ts": round(ev["ts"], 3), "dur": round(ev["dur"], 3),
            "pid": pid, "tid": ev["tid"], "args": args,
        })
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if metrics is not None:
        doc["metrics"] = metrics.snapshot()
    if meta:
        doc["meta"] = dict(meta)
    return doc


def write_chrome_trace(path: str, tracer, metrics=None,
                       meta: dict | None = None) -> None:
    """Atomically write the Chrome-trace JSON document to ``path``."""
    doc = chrome_trace(tracer, metrics, meta)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


def validate_chrome_trace(doc: dict) -> list[str]:
    """Schema check of a Chrome-trace document; returns problem strings
    (empty = valid). Used by the obs tests and the CI trace-smoke step."""
    problems = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return [f"traceEvents is {type(events).__name__}, want list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        for key, types in (("name", str), ("ph", str),
                           ("ts", (int, float)), ("dur", (int, float)),
                           ("pid", int), ("tid", int)):
            if not isinstance(ev.get(key), types):
                problems.append(f"event {i} ({ev.get('name')!r}): bad {key}")
        if ev.get("ph") != "X":
            problems.append(f"event {i}: ph={ev.get('ph')!r}, want 'X'")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"event {i}: args is not an object")
    return problems


def summary_table(tracer, metrics=None) -> str:
    """Human-readable per-span-name aggregation + the counters, as text."""
    agg: dict[str, list[float]] = {}
    for ev in tracer.events():
        agg.setdefault(ev["name"], []).append(ev["dur"])
    lines = []
    if agg:
        width = max(len(n) for n in agg)
        lines.append(f"{'span':<{width}}  {'count':>5}  {'total_us':>12}  "
                     f"{'mean_us':>12}  {'max_us':>12}")
        for name in sorted(agg):
            durs = agg[name]
            lines.append(f"{name:<{width}}  {len(durs):>5}  "
                         f"{sum(durs):>12.1f}  "
                         f"{sum(durs) / len(durs):>12.1f}  "
                         f"{max(durs):>12.1f}")
    if metrics is not None:
        counters = metrics.counters()
        if counters:
            if lines:
                lines.append("")
            width = max(len(n) for n in counters)
            for name in sorted(counters):
                lines.append(f"{name:<{width}}  {counters[name]:>14g}")
        for name, value in sorted(metrics.gauges().items()):
            lines.append(f"{name} = {value:g}")
    return "\n".join(lines) if lines else "(no spans or counters recorded)"
