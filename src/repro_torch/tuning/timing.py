"""Wall-clock timing with warm-up discipline — port of ``repro.tuning.timing``.

One call warms the function (it builds the kernels a first CUDA call
needs; excluded from the measurement), then the timed loop runs.
:func:`time_us` runs ``iters`` calls back to back and waits for the card
once at the end (the mean per call); :func:`time_stats` waits after every
call and returns the distribution (mean/p50/p95/min).

The host clock is read around calls followed by ``torch.cuda.synchronize()``
on each card a CUDA tensor of the result lies on (``obs.synchronize``),
where the reference blocks with ``jax.block_until_ready``; a result on the
CPU is ready when the call returns.

Both refuse functions that consume their inputs: an argument that reports
``is_deleted()`` after the warm-up (the reference's donated buffers) would
make every timed call time garbage, so the guard raises instead.
"""

from __future__ import annotations

import time

from repro_torch.obs import synchronize


def _check_not_donated(fn, args) -> None:
    """Raise if the warm-up call consumed (donated) any input buffer."""
    for i, a in enumerate(args):
        deleted = getattr(a, "is_deleted", None)
        if callable(deleted) and deleted():
            raise ValueError(
                f"argument {i} was donated/deleted by {fn!r} during warm-up; "
                "timing loops need reusable inputs — pass fresh copies")


def time_us(fn, *args, iters: int = 5) -> float:
    """Mean wall time per call of ``fn(*args)`` in microseconds."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    synchronize(fn(*args))  # build + warm
    _check_not_donated(fn, args)
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    synchronize(out)
    return (time.perf_counter() - t0) / iters * 1e6


def _percentile(sorted_us: list[float], q: float) -> float:
    """Nearest-rank percentile of an ascending sample (q in [0, 100])."""
    idx = max(0, min(len(sorted_us) - 1,
                     round(q / 100.0 * (len(sorted_us) - 1))))
    return sorted_us[idx]


def time_stats(fn, *args, iters: int = 5) -> dict:
    """Distribution of per-call wall times of ``fn(*args)``.

    Warms once (excluded), then times ``iters`` calls each waited for
    individually, and returns ``{"mean_us", "p50_us", "p95_us", "min_us",
    "iters"}`` (nearest-rank percentiles).  Waiting after every call gives
    up the overlap of one call's launches with the last one's work on the
    card, so the mean here can sit above :func:`time_us`'s.
    """
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    synchronize(fn(*args))  # build + warm
    _check_not_donated(fn, args)
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        synchronize(fn(*args))
        samples.append((time.perf_counter() - t0) * 1e6)
    samples.sort()
    return {
        "mean_us": sum(samples) / len(samples),
        "p50_us": _percentile(samples, 50.0),
        "p95_us": _percentile(samples, 95.0),
        "min_us": samples[0],
        "iters": iters,
    }
