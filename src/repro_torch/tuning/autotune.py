"""The autotuner: prune with the paper's model, time the survivors, cache —
port of ``repro.tuning.autotune``.

``autotune(grid, n, ...)`` is the programmatic entry point (used by
``make_fft3d(..., autotune=True)``); ``repro_torch.tuning.cli`` wraps it for
the command line.

The objective is inverse-aware: ``w_fwd·t_fwd + w_inv·t_inv`` (default 1:1 —
a spectral solver's time step runs both directions, Fig. 3.3). Set
``inv_weight=0`` to tune the forward transform alone; the weights are part
of the cache fingerprint, so differently-weighted tunings never collide.

What differs from the reference:

* **Ranks.**  On a grid of more than one rank the tuner runs in every rank
  process of :func:`repro_torch.dist.run_ranks`, and each candidate's
  exchanges are collective.  So rank 0 decides the cache lookup and the
  candidate list and every rank follows it in that order; a candidate's
  objective is the max of its times over the ranks; a candidate refused on
  one rank while it is built is dropped on all of them before any of its
  exchanges starts; every rank takes the same winner, and rank 0 writes
  the cache.
* **No hidden failure.**  A sweep drops only what the reference's validity
  rules refuse (:data:`REFUSALS`, raised by plan, grid or backend
  validation).  A CUDA error, a kernel that does not build or does not
  launch, propagates.
"""

from __future__ import annotations

import dataclasses
import datetime
import math

import torch

from repro_torch import dist, obs
from repro_torch.core import perfmodel as pm
from repro_torch.core import precision
from repro_torch.core.decomposition import PencilGrid
from repro_torch.tuning.cache import PlanCache, problem_fingerprint
from repro_torch.tuning.space import DEFAULT_CANDIDATE, Candidate, candidate_space
from repro_torch.tuning.timing import time_us

#: what a candidate may raise and be dropped from a sweep: the validity
#: refusals of plan, grid and backend validation
REFUSALS = (ValueError, NotImplementedError)


@dataclasses.dataclass(frozen=True)
class TuneResult:
    best_config: dict          # kwargs subset for make_fft3d / FFT3DPlan
    best_us: float             # weighted objective of the winner (µs)
    cache_hit: bool
    key: str
    rows: list                 # [{"name", "us_per_call", "us_fwd", "us_inv",
                               #   "config"}] timed sweep

    @property
    def best(self) -> Candidate:
        return Candidate.from_config(self.best_config)


# ---------------------------------------------------------------------------
# agreement over the ranks of a grid (identity on one rank)
# ---------------------------------------------------------------------------

def _ranked(grid: PencilGrid) -> bool:
    return grid.p > 1 and dist.context() is not None


def _from_rank0(grid: PencilGrid, obj):
    """Rank 0's ``obj`` on every rank."""
    if not _ranked(grid):
        return obj
    box = [obj]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


def _max_over_ranks(grid: PencilGrid, value: float) -> float:
    if not _ranked(grid):
        return value
    return float(dist.all_reduce(torch.tensor(float(value), dtype=torch.float64),
                                 "max"))


def _all_ok(grid: PencilGrid, ok: bool) -> bool:
    """True when ``ok`` holds on every rank."""
    return _max_over_ranks(grid, 0.0 if ok else 1.0) == 0.0


def _lookup(grid: PencilGrid, cache: PlanCache, key: str, force: bool):
    """The cached result of ``key`` (rank 0 reads the file), or None."""
    entry = None
    if not force and (not _ranked(grid) or dist.context().rank == 0):
        entry = cache.get(key)
    entry = _from_rank0(grid, entry)
    if entry is None:
        return None
    return TuneResult(best_config=entry["best"], best_us=entry["us_per_call"],
                      cache_hit=True, key=key, rows=entry.get("rows", []))


def sweep(grid: PencilGrid, keep: list, build, measure, *, key: str,
          cache: PlanCache, problem: dict, label: str = "",
          verbose: bool = False) -> TuneResult:
    """Time every candidate of ``keep`` (rank 0's list, in its order) and
    cache the winner.

    ``build(cand)`` makes what one candidate runs without communicating
    (a refusal there, on any rank, drops the candidate on every rank);
    ``measure(built)`` times it and returns the row's numbers, ``{"us",
    ...}``; a refusal there drops it too, which the ranks must then all
    raise.  The objective is the max of ``us`` over the ranks.  Raises
    ``RuntimeError`` when no candidate ran.
    """
    keep = _from_rank0(grid, keep)
    say = verbose and (not _ranked(grid) or dist.context().rank == 0)
    rows = []
    for cand in keep:
        name = f"{label}{cand.name}"
        built, why = None, None
        try:
            built = build(cand)
        except REFUSALS as e:
            why = e
        if _all_ok(grid, why is None):
            try:
                with obs.span("tune/candidate", candidate=cand.name,
                              problem=key) if obs.is_enabled() else obs.NULL_SPAN:
                    got = measure(built)
                obs.metrics.inc("tuning.candidates_timed")
            except REFUSALS as e:
                why, got = e, None
            ok = _all_ok(grid, why is None)
        else:
            ok = False
        del built
        if not ok:
            if say:
                reason = f"{type(why).__name__}: {why}" if why else "on another rank"
                print(f"  tune {name}: REFUSED ({reason})")
            continue
        got = {k: _max_over_ranks(grid, v) for k, v in got.items()}
        row = {"name": cand.name, "us_per_call": round(got.pop("us"), 3)}
        row.update({k: round(v, 3) for k, v in got.items()})
        row["config"] = cand.config()
        rows.append(row)
        if say:
            print(f"  tune {name}: {row['us_per_call']:.1f} us")
    if not rows:
        raise RuntimeError(f"autotune: no candidate ran for problem {key}")

    best = min(rows, key=lambda r: r["us_per_call"])
    entry = {
        "problem": problem,
        "best": best["config"],
        "best_name": best["name"],
        "us_per_call": best["us_per_call"],
        "rows": rows,
        "created": datetime.datetime.now(datetime.timezone.utc).isoformat(),
    }
    if not _ranked(grid) or dist.context().rank == 0:
        cache.put(key, entry)
    return TuneResult(best_config=best["config"],
                      best_us=best["us_per_call"], cache_hit=False, key=key,
                      rows=rows)


def _estimate(cand: Candidate, n, grid: PencilGrid, components: int) -> float:
    return pm.estimate_plan_seconds(
        n, grid.pu, grid.pv, spec=cand.spec(), mu=max(components, 1),
        pu_axes=grid.u_sizes, pv_axes=grid.v_sizes)


def _pencil_input(grid: PencilGrid, n, *, real: bool, components: int,
                  dtype, device):
    """This rank's block of a seeded X-pencil (a planar pair unless real)."""
    nx, ny, nz = n
    shape = ((components,) if components else ()) + (ny // grid.pu,
                                                     nz // grid.pv, nx)
    dev = torch.device(device)
    g = torch.Generator(dev).manual_seed(0)
    xr = torch.randn(shape, dtype=precision.torch_dtype(dtype), device=dev,
                     generator=g)
    return (xr,) if real else (xr, torch.zeros_like(xr))


def _build_pair(grid, n, cand: Candidate, *, real, components, device):
    from repro_torch.core.fft3d import make_fft3d

    fwd, inv, _plan = make_fft3d(grid, n, spec=cand.spec(real=real),
                                 components=components, device=device)
    return fwd, inv


def _time_pair(fwd, inv, args, iters: int, time_inverse: bool):
    us_fwd = time_us(fwd, *args, iters=iters)
    us_inv = time_us(inv, *fwd(*args), iters=iters) if time_inverse else 0.0
    return us_fwd, us_inv


def time_candidate_pair(grid, n, cand: Candidate, *, real: bool = False,
                        components: int = 0, dtype="float32", device="cuda",
                        iters: int = 3,
                        time_inverse: bool = True) -> tuple[float, float]:
    """Measured ``(us_fwd, us_inv)`` of one candidate on this rank (the
    first call, which builds the kernels, excluded).

    The inverse is timed on the spectral field the forward produces
    (``us_inv = 0.0`` when ``time_inverse`` is off).  On a grid of more
    than one rank, call it in every rank process.
    """
    n = (n, n, n) if isinstance(n, int) else tuple(n)
    fwd, inv = _build_pair(grid, n, cand, real=real, components=components,
                           device=device)
    args = _pencil_input(grid, n, real=real, components=components,
                         dtype=dtype, device=device)
    return _time_pair(fwd, inv, args, iters, time_inverse)


def time_candidate(grid, n, cand: Candidate, *, inverse: bool = False,
                   **kw) -> float:
    """Measured µs/transform in one direction (see ``time_candidate_pair``)."""
    us_fwd, us_inv = time_candidate_pair(grid, n, cand, time_inverse=inverse,
                                         **kw)
    return us_inv if inverse else us_fwd


def autotune(grid, n, *, real: bool = False, components: int = 0,
             dtype="float32", device="cuda", cache_path: str | None = None,
             max_candidates: int = 8, iters: int = 3, force: bool = False,
             fwd_weight: float = 1.0, inv_weight: float = 1.0,
             verbose: bool = False) -> TuneResult:
    """Pick the fastest ``FFT3DPlan`` configuration for this problem.

    The sweep is ranked by the paper's analytic model and only the top
    ``max_candidates`` (plus the hardcoded default, which is always timed so
    the winner is never slower than the status quo) are measured. Each
    survivor is scored ``fwd_weight·t_fwd + inv_weight·t_inv`` (µs; the
    inverse timing is skipped entirely when ``inv_weight == 0``). Results
    persist in the JSON plan cache; a repeat call with the same fingerprint
    — which includes the weights — returns without timing anything.
    ``force=True`` re-times and overwrites.  ``grid`` is a
    :class:`PencilGrid`; one of more than one rank runs in the rank
    processes of :func:`repro_torch.dist.run_ranks` (see the module text).
    """
    if fwd_weight < 0 or inv_weight < 0 or fwd_weight + inv_weight <= 0:
        raise ValueError(f"weights must be non-negative and not both zero, "
                         f"got fwd={fwd_weight} inv={inv_weight}")
    if iters < 1:  # fail before the sweep, not inside every candidate
        raise ValueError(f"iters must be >= 1, got {iters}")
    grid = dist.bind_grid(grid, "autotune")
    dev = torch.device(device)
    n = (n, n, n) if isinstance(n, int) else tuple(n)
    grid.validate(n)
    dtype = precision.require_dtype(dtype, who="autotune").name
    key, problem = problem_fingerprint(
        n, grid.pu, grid.pv, real=real, components=components, dtype=dtype,
        u_axes=grid.u_axes, v_axes=grid.v_axes,
        fwd_weight=fwd_weight, inv_weight=inv_weight, device=dev)
    cache = PlanCache(cache_path)
    hit = _lookup(grid, cache, key, force)
    if hit is not None:
        return hit

    cands = candidate_space(n, grid.pu, grid.pv, real=real,
                            components=components,
                            pu_axes=grid.u_sizes, pv_axes=grid.v_sizes)
    cands.sort(key=lambda c: _estimate(c, n, grid, components))
    keep = cands[:max(max_candidates, 1)]
    if DEFAULT_CANDIDATE not in keep:
        keep.append(DEFAULT_CANDIDATE)

    def build(cand):
        return _build_pair(grid, n, cand, real=real, components=components,
                           device=dev)

    def measure(pair):
        args = _pencil_input(grid, n, real=real, components=components,
                             dtype=dtype, device=dev)
        us_fwd, us_inv = _time_pair(*pair, args, iters, inv_weight > 0)
        return {"us": fwd_weight * us_fwd + inv_weight * us_inv,
                "us_fwd": us_fwd, "us_inv": us_inv}

    return sweep(grid, keep, build, measure, key=key, cache=cache,
                 problem=problem, verbose=verbose)


def speedup_vs_default(result: TuneResult) -> float:
    """Measured default-plan objective / best objective (≥ 1.0 when the sweep
    timed the default; ``nan`` on a cache hit whose rows were not stored)."""
    for row in result.rows:
        if Candidate.from_config(row["config"]) == DEFAULT_CANDIDATE:
            return row["us_per_call"] / max(result.best_us, 1e-9)
    return math.nan
