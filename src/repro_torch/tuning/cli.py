"""Autotuner command line — port of ``repro.tuning.cli``.

    PYTHONPATH=src python -m repro_torch.tuning.cli --n 512 --mesh 1x1 \\
        --case heat --dtype float64
    PYTHONPATH=src python -m repro_torch.tuning.cli --n 16 --mesh 2x2 \\
        --device cpu --iters 1 --max-candidates 2 --cache plans.json \\
        --json B.json

Sweeps the ``FFT3DPlan`` space for the given problem on a Pu×Pv grid (one
rank process each when Pu·Pv > 1, :func:`repro_torch.dist.run_ranks`),
writes the winner to the persistent plan cache, and emits the measured
sweep as ``BENCH_fft.json`` rows (``{name, us_per_call, config}``).  A
second invocation with the same problem is a cache hit and times nothing.
Rank 0 prints and writes.

``--case <solver>`` switches the objective from the bare transform to a
registered ``repro_torch.solvers`` case's *whole step* (µs/step; the real/
components shape then comes from the solver class, and ``--fwd-weight/
--inv-weight`` don't apply).  The document's ``meta`` names torch, the
device and, on the card, its power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: current bench-document schema: v2 rows may carry ``p50_us``/``p95_us``
#: (tail timing) and ``model_predicted_us``/``model_err`` (perf-model drift)
#: next to ``us_per_call``; readers accept both generations
BENCH_SCHEMA = "bench-fft/v2"
BENCH_SCHEMAS = ("bench-fft/v1", BENCH_SCHEMA)


def write_bench_json(path: str, rows: list, meta: dict) -> None:
    """Write/merge ``BENCH_fft.json``: same-name rows are replaced in place.

    Always writes the current schema; an existing v1 document's rows are
    merged and carried forward into the upgraded document.
    """
    doc = {"schema": BENCH_SCHEMA, "meta": meta, "rows": []}
    try:
        with open(path) as f:
            old = json.load(f)
        if old.get("schema") in BENCH_SCHEMAS and isinstance(old.get("rows"), list):
            doc["rows"] = [r for r in old["rows"]
                           if r.get("name") not in {x["name"] for x in rows}]
            doc["meta"] = {**old.get("meta", {}), **meta}
    except (FileNotFoundError, json.JSONDecodeError):
        pass
    doc["rows"].extend(rows)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


def substrate_meta(device) -> dict:
    """The plan cache's substrate fields (torch, CUDA, the device and their
    count) and, for a card, its name and power limit as ``nvidia-smi``
    reports them."""
    import torch

    from repro_torch.tuning.cache import substrate

    meta = substrate(device)
    if torch.device(device).type == "cuda":
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True, timeout=60)
            meta["card"] = smi.stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError) as e:
            meta["card"] = f"not read: {e}"
    return meta


def _tune(args, grid, rank: int = 0) -> int:
    """Run the sweep on this rank; rank 0 prints and writes."""
    from repro_torch import obs
    from repro_torch.tuning import autotune
    from repro_torch.tuning.autotune import speedup_vs_default
    from repro_torch.tuning.cache import PlanCache

    if args.trace_path:
        obs.clear()
        obs.enable()
    try:
        if args.case:
            from repro_torch.tuning.solver import autotune_solver_step
            result = autotune_solver_step(
                grid, args.case, args.n, dtype=args.dtype,
                cache_path=args.cache, max_candidates=args.max_candidates,
                iters=args.iters, force=args.force, device=args.device,
                verbose=True)
        else:
            result = autotune(grid, args.n, real=args.real,
                              components=args.components, dtype=args.dtype,
                              device=args.device, cache_path=args.cache,
                              max_candidates=args.max_candidates,
                              iters=args.iters, force=args.force,
                              fwd_weight=args.fwd_weight,
                              inv_weight=args.inv_weight, verbose=True)
    except ValueError as e:  # e.g. an unknown case or dtype
        if rank == 0:
            print(f"invalid problem for mesh {args.mesh}: {e}", file=sys.stderr)
        return 1
    if rank != 0:
        return 0

    src = "cache HIT (nothing re-timed)" if result.cache_hit else "measured sweep"
    unit = "us/step" if args.case else "us/call"
    print(f"selected [{src}]: {result.best.name}  {result.best_us:.1f} {unit}")
    sp = speedup_vs_default(result)
    if sp == sp:  # not nan
        print(f"speedup vs default (jnp/seq/switched): {sp:.2f}x")
    print(f"plan cache: {PlanCache(args.cache).path}  key={result.key}")

    if args.json_path:
        prefix = f"autotune/{result.key}"
        rows = [{"name": f"{prefix}/{r['name']}",
                 "us_per_call": r["us_per_call"], "config": r["config"]}
                for r in result.rows]
        rows.append({"name": f"{prefix}/selected",
                     "us_per_call": result.best_us,
                     "config": result.best_config})
        meta = {**substrate_meta(args.device), "ranks": grid.p,
                "argv": list(args.argv)}
        write_bench_json(args.json_path, rows, meta)
        print(f"wrote {args.json_path} ({len(rows)} rows)")
    if args.trace_path:
        obs.disable()
        obs.write_chrome_trace(args.trace_path, obs.tracer, obs.metrics)
        print(f"wrote trace {args.trace_path} "
              f"({len(obs.tracer.events())} spans)")
    return 0


def _rank_main(ctx, args) -> int:
    return _tune(args, ctx.grid(), rank=ctx.rank)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.tuning.cli",
        description="Autotune the distributed 3D-FFT plan for one problem.")
    ap.add_argument("--n", type=int, default=64, help="cubic grid extent N")
    ap.add_argument("--mesh", default="4x2", help="Pu x Pv pencil grid, e.g. 4x2")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a CPU run)")
    ap.add_argument("--case", default="",
                    help="tune a repro_torch.solvers case's whole step instead "
                         "of the bare transform (poisson | heat | "
                         "navier_stokes | nls)")
    ap.add_argument("--real", action="store_true", help="real-to-complex input")
    ap.add_argument("--components", type=int, default=0,
                    help="μ vector components (0 = scalar field)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--iters", type=int, default=3, help="timed calls/candidate")
    ap.add_argument("--fwd-weight", type=float, default=1.0,
                    help="objective weight of the forward transform time")
    ap.add_argument("--inv-weight", type=float, default=1.0,
                    help="objective weight of the inverse transform time "
                         "(0 = forward-only tuning)")
    ap.add_argument("--max-candidates", type=int, default=8,
                    help="model-pruned sweep size (default plan always added)")
    ap.add_argument("--cache", default=None,
                    help="plan-cache path (default: $REPRO_TORCH_PLAN_CACHE or "
                         "~/.cache/repro_torch/fft_plans.json)")
    ap.add_argument("--json", dest="json_path", default="BENCH_fft.json",
                    help="benchmark-rows output ('' disables)")
    ap.add_argument("--force", action="store_true",
                    help="ignore any cached plan and re-time")
    ap.add_argument("--trace", dest="trace_path", default="",
                    help="write a Chrome-trace JSON (Perfetto-loadable) of "
                         "the sweep: one tune/candidate span per timed "
                         "candidate plus the wire/cache counters (rank 0's)")
    args = ap.parse_args(argv)
    args.argv = list(argv) if argv is not None else sys.argv[1:]

    from repro_torch import dist
    from repro_torch.core.decomposition import PencilGrid

    try:
        pu, pv = (int(p) for p in args.mesh.lower().split("x"))
        grid = PencilGrid.from_mesh(pu, pv)
        grid.validate((args.n,) * 3)
    except ValueError as e:  # e.g. N not divisible by the pencil grid
        raise SystemExit(f"invalid problem for mesh {args.mesh}: {e}")
    objective = (f"{args.case} step" if args.case else
                 f"{args.fwd_weight:g}*t_fwd+{args.inv_weight:g}*t_inv")
    print(f"autotune: N={args.n}^3 mesh={pu}x{pv} real={args.real} "
          f"components={args.components} dtype={args.dtype} "
          f"objective={objective} [{args.device}: {grid.p} rank(s)]",
          flush=True)
    if grid.p == 1:
        return _tune(args, grid)
    return max(dist.run_ranks(_rank_main, pu, pv, device=args.device,
                              args=(args,)))


if __name__ == "__main__":
    raise SystemExit(main())
