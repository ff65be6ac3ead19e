"""Measured calibration of the analytic performance model — port of
``repro.tuning.calibrate``.

    PYTHONPATH=src python -m repro_torch.tuning.calibrate --mesh 4x1
    PYTHONPATH=src python -m repro_torch.tuning.calibrate --quick --mesh 2x1 \\
        --device cpu --trace calib.trace.json   # tune/ span per stage

The perf model's pruning constants — ``ENGINE_MESSAGE_OVERHEAD_S`` (exposed
per-message dispatch cost of each TransposeEngine), ``BACKEND_COMPUTE_WEIGHT``
(relative cost of each 1D FFT backend) and ``LINK_BYTES_PER_S`` — ship as
priors derived from earlier H100 measurements.  This module measures them
on the *current* substrate and persists them as a fingerprinted
``calibration.json`` (same discipline as the plan cache: a calibration is
only ever replayed on the exact substrate that produced it — torch and CUDA
versions, device type, device name, device count).

Once written, the calibration is picked up lazily by
``perfmodel.message_overhead_s`` / ``perfmodel.backend_compute_weight`` /
``perfmodel.link_bytes_per_s`` and therefore flows through
``estimate_plan_seconds``, ``optimal_chunks`` / ``chunk_candidates``,
``tuning.space`` candidate enumeration, and ``topology.NetworkPlan`` — the
priors remain as fallbacks for engines/backends the run could not measure.

Measurement method:

* **engine message overhead** — each engine's X↔Y fold is timed at two
  payload sizes through the real exchange; the per-message cost is the
  zero-payload extrapolation ``t(0)/messages`` of the linear model
  ``t(bytes) = overhead + bytes/bw``.  Needs a communicating grid, so it
  runs in the rank processes of :func:`repro_torch.dist.run_ranks`: every
  rank times the same fold in lockstep and the time is the max over the
  ranks.  On a 1×1 grid nothing can be measured and the priors stand.
* **wire bandwidth** — the *slope* of the same two-size fit; the median
  over the measured engines is persisted as ``link_bytes_per_s``.
* **backend compute weight** — each backend's 1D c2c transform is timed on
  an identical planar batch; the weight is the ratio to ``jnp``
  (``torch.fft``, the 1.0 reference, as the priors are normalized).

On the card the measurement runs at the main path's shapes, where the
reference's are launch-bound: the backends in the solvers' float64 at
N=512 with 512·512 rows (``fft_mxu`` runs f32 on CUDA cores and f64 on the
FP64 tensor cores, so an f32 weight would misrank it for every f64 solver),
the folds at N=128 and 256 (at the reference's 8³ and 16³ the slope is
noise).  ``measure_backend_weights(dtype=)`` and
``measure_engine_overheads(sizes=)`` take them.

File location: ``$REPRO_TORCH_CALIBRATION`` or
``~/.cache/repro_torch/calibration.json`` (one document per substrate —
writing atomically replaces the previous one).
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import statistics

import torch

from repro_torch import dist
from repro_torch.tuning.autotune import REFUSALS, _all_ok, _max_over_ranks, _ranked
from repro_torch.tuning.cache import substrate

SCHEMA = "fft-calibration/v1"
ENV_VAR = "REPRO_TORCH_CALIBRATION"

#: substrate identity keys a calibration must match to be replayed
FINGERPRINT_KEYS = ("torch_version", "cuda_version", "device_type",
                    "device_name", "device_count")

#: floor for a measured per-message overhead: the zero-payload extrapolation
#: is noise-sensitive, and a non-positive fit means the measurement carries
#: no signal (fall back to the prior rather than persisting nonsense)
MIN_OVERHEAD_S = 1e-9

#: floor for a measured backend weight (jnp is the 1.0 reference)
MIN_WEIGHT = 1e-3

#: the card's measurement shapes (see the module text)
CARD_BACKEND_SHAPE = {"rows": 512 * 512, "length": 512, "dtype": "float64"}
CARD_FOLD_SIZES = (128, 256)


def default_calibration_path() -> str:
    """``$REPRO_TORCH_CALIBRATION`` if set, else
    ``~/.cache/repro_torch/calibration.json``."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "calibration.json")


def substrate_fingerprint(device=None) -> dict:
    """Canonical identity of the measurement substrate (cf. the plan cache:
    a calibration must never be replayed where it would not transfer)."""
    return substrate(device)


def _say(verbose: bool, line: str) -> None:
    ctx = dist.context()
    if verbose and (ctx is None or ctx.rank == 0):
        print(line, flush=True)


# ---------------------------------------------------------------------------
# microbenchmarks
# ---------------------------------------------------------------------------

def measure_backend_weights(*, rows: int = 64, length: int = 256,
                            iters: int = 5, dtype: str = "float32",
                            device="cuda", verbose: bool = False) -> dict:
    """Measured ``BACKEND_COMPUTE_WEIGHT`` replacement: per-backend 1D c2c
    wall time over an identical planar batch of ``dtype`` on ``device``,
    normalized to ``jnp``.

    A backend whose validity rules refuse the batch is skipped (its prior
    stands); any other failure propagates.  Returns ``{}`` when the ``jnp``
    reference itself cannot be timed.
    """
    from repro_torch.core import precision
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops as kops
    from repro_torch.tuning.timing import time_us

    dev = resolve_device(device)
    g = torch.Generator(dev).manual_seed(0)
    xr = torch.randn((rows, length), dtype=precision.torch_dtype(dtype),
                     device=dev, generator=g)
    xi = torch.zeros_like(xr)
    times: dict[str, float] = {}
    for backend in kops.BACKENDS:
        def fn(a, b, bk=backend):
            return kops.fft1d(a, b, backend=bk)
        try:
            times[backend] = time_us(fn, xr, xi, iters=iters)
        except REFUSALS as e:  # invalid here — keep its prior
            _say(verbose, f"  calibrate backend {backend}: REFUSED "
                          f"({type(e).__name__}: {e})")
            continue
        _say(verbose, f"  calibrate backend {backend}: "
                      f"{times[backend]:.1f} us")
    base = times.get("jnp")
    if not base or base <= 0:
        return {}
    return {b: max(round(t / base, 4), MIN_WEIGHT) for b, t in times.items()}


def _fold_sizes(pu: int, pv: int) -> tuple[int, int]:
    """Two pencil-divisible cubic extents for the zero-payload fit."""
    m = math.lcm(max(pu, 1), max(pv, 1))
    n1 = m * max(1, -(-8 // m))  # smallest multiple of m that is >= 8
    return n1, 2 * n1


def measure_engine_overheads(grid, *, iters: int = 5, sizes=None,
                             verbose: bool = False) -> tuple[dict, float]:
    """Measured ``ENGINE_MESSAGE_OVERHEAD_S`` replacement, plus the wire
    bandwidth the same fit yields.

    Times every registered TransposeEngine's X↔Y fold (the real exchange,
    on the device of this rank) at two payload sizes, the cubic extents
    ``sizes`` (default :func:`_fold_sizes`), and extrapolates to zero
    payload: ``t(bytes) = c + bytes/bw`` gives the size-independent
    dispatch cost ``c = messages · t_msg`` as the intercept — and the
    bytes-per-second actually moved, ``bw = Δbytes/Δt``, as the slope.
    Returns ``(overheads, link_bytes_per_s)`` where the bandwidth is the
    median slope over the measured engines (0.0 when nothing measured).
    Engines whose fit is non-positive (noise) or that the validity rules
    refuse are skipped; a non-communicating grid returns ``({}, 0.0)``.
    On a grid of more than one rank, call it in every rank process: each
    time is the max over the ranks, so every rank returns the same.
    """
    from repro_torch.core import comm
    from repro_torch.core import perfmodel as pm
    from repro_torch.core.decomposition import XY_STEP
    from repro_torch.core.engine_spec import EngineSpec
    from repro_torch.tuning.timing import time_us

    grid = dist.bind_grid(grid, "measure_engine_overheads")
    if grid.pu <= 1:  # the X<->Y fold moves data along the Pu ranks only
        return {}, 0.0
    n1, n2 = tuple(sizes) if sizes else _fold_sizes(grid.pu, grid.pv)
    dev = dist.context().device
    g = torch.Generator().manual_seed(dist.context().rank)
    out: dict[str, float] = {}
    slopes: list[float] = []
    for name in comm.ENGINE_NAMES:
        msgs = pm.fold_messages(grid.pu, pm.ENGINE_FABRIC[name], name)
        if msgs <= 0:
            continue
        eng = comm.build_engine(EngineSpec(engine=name), grid)
        ts, why = [], None
        try:
            for n in (n1, n2):
                x = torch.randn((n // grid.pu, n // grid.pv, n),
                                dtype=torch.float32, generator=g).to(dev)
                ts.append(time_us(lambda a, e=eng: e.fold_step(XY_STEP, a),
                                  x, iters=iters) * 1e-6)
        except REFUSALS as e:  # invalid here — keep its prior
            why = e
        if not _all_ok(grid, why is None):
            _say(verbose, f"  calibrate engine {name}: REFUSED ({why})")
            continue
        ts = [_max_over_ranks(grid, t) for t in ts]
        b1, b2 = float(n1) ** 3 * 4, float(n2) ** 3 * 4
        t0 = ts[0] - b1 * (ts[1] - ts[0]) / (b2 - b1)  # zero-payload intercept
        t_msg = t0 / msgs
        slope = (b2 - b1) / (ts[1] - ts[0]) if ts[1] > ts[0] else 0.0
        _say(verbose, f"  calibrate engine {name}: t({n1}^3)={ts[0] * 1e6:.1f}us "
                      f"t({n2}^3)={ts[1] * 1e6:.1f}us -> "
                      f"t_msg={t_msg * 1e6:.3f}us ({msgs} msgs) "
                      f"bw={slope / 1e9:.2f} GB/s")
        if t_msg >= MIN_OVERHEAD_S:
            out[name] = float(f"{t_msg:.3e}")
        if slope > 0 and math.isfinite(slope):
            slopes.append(slope)
    link = statistics.median(slopes) if slopes else 0.0
    return out, float(f"{link:.3e}") if link > 0 else 0.0


# ---------------------------------------------------------------------------
# document IO (mirrors the plan cache's atomic-write discipline)
# ---------------------------------------------------------------------------

def calibration_document(mesh: str, overheads: dict, link: float,
                         weights: dict, *, quick: bool, iters: int,
                         device=None) -> dict:
    """The calibration document of measurements taken on ``device``."""
    doc = {
        "schema": SCHEMA,
        "fingerprint": substrate_fingerprint(device),
        "mesh": mesh,
        "quick": bool(quick),
        "iters": int(iters),
        "engine_message_overhead_s": dict(overheads),
        "backend_compute_weight": dict(weights),
        "created": datetime.datetime.now(datetime.timezone.utc).isoformat(),
    }
    if link > 0:
        doc["link_bytes_per_s"] = link
    return doc


def run_calibration(grid, *, quick: bool = False, iters: int | None = None,
                    device="cuda", verbose: bool = False) -> dict | None:
    """Run both microbenchmarks on ``device`` and assemble the calibration
    document.  On a grid of more than one rank, call it in every rank
    process: the folds are timed by all, the backends by rank 0, which
    alone gets the document (the others get None)."""
    from repro_torch import obs
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if iters is None:
        iters = 2 if quick else 5
    card = dev.type == "cuda"
    if card:
        shape, sizes = CARD_BACKEND_SHAPE, CARD_FOLD_SIZES
    else:
        rows, length = (16, 64) if quick else (64, 256)
        shape, sizes = {"rows": rows, "length": length, "dtype": "float32"}, None
    grid = dist.bind_grid(grid, "run_calibration")
    with obs.span("tune/calibrate.engines", mesh=f"{grid.pu}x{grid.pv}") \
            if obs.is_enabled() else obs.NULL_SPAN:
        overheads, link = measure_engine_overheads(grid, iters=iters,
                                                   sizes=sizes, verbose=verbose)
    if _ranked(grid) and dist.context().rank != 0:
        return None
    with obs.span("tune/calibrate.backends"):
        weights = measure_backend_weights(iters=iters, device=dev,
                                          verbose=verbose, **shape)
    return calibration_document(f"{grid.pu}x{grid.pv}", overheads, link,
                                weights, quick=quick, iters=iters, device=dev)


def validate_calibration(doc) -> list[str]:
    """Well-formedness problems of a calibration document ([] = valid).

    Valid means: right schema, a complete substrate fingerprint, both
    measurement tables present as dicts of positive finite floats over
    *known* engine/backend names, an optional ``link_bytes_per_s`` scalar
    that is positive and finite when present, and at least one measured
    value overall (an all-empty calibration carries no signal worth
    persisting).
    """
    from repro_torch.core import perfmodel as pm
    from repro_torch.kernels.ops import BACKENDS

    problems = []
    if not isinstance(doc, dict):
        return [f"not a JSON object: {type(doc).__name__}"]
    if doc.get("schema") != SCHEMA:
        problems.append(f"schema: expected {SCHEMA!r}, got {doc.get('schema')!r}")
    fp = doc.get("fingerprint")
    if not isinstance(fp, dict):
        problems.append("fingerprint: missing or not an object")
    else:
        for key in FINGERPRINT_KEYS:
            if not fp.get(key):
                problems.append(f"fingerprint.{key}: missing or empty")
    known = {"engine_message_overhead_s": set(pm.ENGINE_MESSAGE_OVERHEAD_S),
             "backend_compute_weight": set(BACKENDS)}
    measured = 0
    for table, names in known.items():
        vals = doc.get(table)
        if not isinstance(vals, dict):
            problems.append(f"{table}: missing or not an object")
            continue
        for name, v in vals.items():
            if name not in names:
                problems.append(f"{table}.{name}: unknown name")
            elif not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or not math.isfinite(v) or v <= 0:
                problems.append(f"{table}.{name}: not a positive finite "
                                f"number: {v!r}")
            else:
                measured += 1
    link = doc.get("link_bytes_per_s")
    if link is not None:
        if not isinstance(link, (int, float)) or isinstance(link, bool) \
                or not math.isfinite(link) or link <= 0:
            problems.append(f"link_bytes_per_s: not a positive finite "
                            f"number: {link!r}")
        else:
            measured += 1
    if not problems and measured == 0:
        problems.append("no measured values in either table")
    return problems


def save_calibration(doc: dict, path: str | None = None) -> str:
    """Atomically write ``doc`` (tmp file + ``os.replace``, like the plan
    cache) and return the path written."""
    path = path or default_calibration_path()
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_calibration(path: str | None = None) -> dict | None:
    """The raw document at ``path`` (default location), or None."""
    path = path or default_calibration_path()
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError, OSError):
        return None


def load_active_calibration(path: str | None = None) -> dict | None:
    """The calibration the perf model should consult on *this* substrate.

    None unless the document exists, is well-formed, and its fingerprint
    matches the current process exactly — a calibration measured under
    another torch/CUDA/device configuration must not transfer (the
    plan-cache discipline).  This is what ``perfmodel.active_calibration``
    loads lazily on first use.
    """
    doc = load_calibration(path)
    if doc is None or validate_calibration(doc):
        return None
    if doc["fingerprint"] != substrate_fingerprint():
        return None
    return doc


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _measure(args, grid, rank: int = 0) -> int:
    """Calibrate on this rank; rank 0 validates, writes and prints."""
    from repro_torch import obs
    from repro_torch.core import perfmodel as pm

    if args.trace_path:
        obs.clear()
        obs.enable()
    doc = run_calibration(grid, quick=args.quick, iters=args.iters,
                          device=args.device, verbose=True)
    if rank != 0:
        return 0
    if args.trace_path:
        obs.disable()
        obs.write_chrome_trace(args.trace_path, obs.tracer, obs.metrics)
        print(f"wrote trace {args.trace_path} "
              f"({len(obs.tracer.events())} spans)")
    problems = validate_calibration(doc)
    if problems:
        print("calibration NOT written — measurement produced an invalid "
              "document:")
        for p in problems:
            print(f"  {p}")
        return 2
    path = save_calibration(doc, args.out)
    if load_active_calibration(path) is None:
        print(f"calibration at {path} failed the replay check "
              "(fingerprint/round-trip mismatch)")
        return 2

    print(f"wrote {path}")
    for engine, t in sorted(doc["engine_message_overhead_s"].items()):
        prior = pm.ENGINE_MESSAGE_OVERHEAD_S[engine]
        print(f"  message overhead {engine:<13} {t * 1e6:8.3f} us  "
              f"(prior {prior * 1e6:.3f} us)")
    for backend, w in sorted(doc["backend_compute_weight"].items()):
        prior = pm.BACKEND_COMPUTE_WEIGHT.get(backend, 1.0)
        print(f"  compute weight   {backend:<13} {w:8.3f}     "
              f"(prior {prior:.3f})")
    link = doc.get("link_bytes_per_s")
    if link:
        print(f"  wire bandwidth   {'median slope':<13} "
              f"{link / 1e9:8.2f} GB/s (prior "
              f"{pm.LINK_BYTES_PER_S / 1e9:.1f} GB/s)")
    # this process measured fresh values — let its own model use them too
    pm.set_calibration(doc)
    return 0


def _rank_main(ctx, args) -> int:
    return _measure(args, ctx.grid(), rank=ctx.rank)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.tuning.calibrate",
        description="Measure per-engine message overheads and per-backend "
                    "compute weights on this substrate and persist them as "
                    "a fingerprinted calibration.json the perf model "
                    "prefers over its built-in priors.")
    ap.add_argument("--mesh", default="4x2",
                    help="Pu x Pv pencil grid to measure the fold exchanges "
                         "on (one rank process each)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a CPU run)")
    ap.add_argument("--quick", action="store_true",
                    help="smoke mode: fewer iterations (and off the card "
                         "smaller batches)")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed calls per measurement (default 5, quick 2)")
    ap.add_argument("--out", default=None,
                    help="output path (default: $REPRO_TORCH_CALIBRATION or "
                         "~/.cache/repro_torch/calibration.json)")
    ap.add_argument("--trace", dest="trace_path", default="",
                    help="write a Chrome-trace JSON (Perfetto-loadable) of "
                         "the calibration run: one tune/ span per timed "
                         "measurement stage (rank 0's)")
    args = ap.parse_args(argv)

    from repro_torch.core.decomposition import PencilGrid

    try:
        pu, pv = (int(p) for p in args.mesh.lower().split("x"))
        grid = PencilGrid.from_mesh(pu, pv)
    except ValueError:
        raise SystemExit(f"--mesh must look like PUxPV, got {args.mesh!r}")
    print(f"calibrate: mesh={pu}x{pv} quick={args.quick} "
          f"[{args.device}: {grid.p} rank(s)]", flush=True)
    if grid.p == 1:
        return _measure(args, grid)
    return max(dist.run_ranks(_rank_main, pu, pv, device=args.device,
                              args=(args,)))


if __name__ == "__main__":
    raise SystemExit(main())
