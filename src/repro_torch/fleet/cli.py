"""The ensemble fleet's command line: schedule many solver jobs, survive the chaos.

    PYTHONPATH=src python -m repro_torch.fleet.cli --case heat --n 512 \\
        --steps 4 --jobs 2 --submesh 1x1 --slots 2 --report fleet.json

    # kill every worker after step 3, prove the merged observables equal
    # the unkilled campaign's bit for bit (on the CPU: --device cpu)
    PYTHONPATH=src python -m repro_torch.fleet.cli --device cpu --case heat \\
        --n 16 --steps 4 --jobs 2 --submesh 2x1 --slots 4 \\
        --inject kill-at-step:3 --report chaos.json

    # a parameter sweep: one job per value, e.g. four diffusivities
    PYTHONPATH=src python -m repro_torch.fleet.cli --device cpu --case heat \\
        --n 16 --steps 4 --sweep kappa=0.05,0.1,0.15,0.2 --submesh 2x2 --slots 8

Port of ``repro.fleet.cli``: the reference's flags, plus ``--device``
(default ``cuda``): every job's ranks run there.  Without a card the
default raises before anything is launched, as every entry point of the
port does (``repro_torch.device.resolve_device``); nothing runs on the CPU
unless ``--device cpu`` asks for it.  A slot is one rank process; on one
card they all share it (:mod:`repro_torch.fleet.controller`).

Builds the ensemble (``--sweep key=v1,v2,...`` makes one job per value;
otherwise ``--jobs K`` replicas at staggered initial amplitudes), runs it
through :class:`repro_torch.fleet.controller.FleetController` — supervised
subprocess workers, checkpoint/restart, fault injection, retry with capped
backoff, quarantine on an exhausted budget — prints a per-job summary plus
the ``fleet.*`` counters, and optionally writes the full
``fleet-report/v1`` JSON. Exit code 0 when every job completed, 1 when any
was quarantined (the campaign itself always runs to completion either
way).
"""

from __future__ import annotations

import argparse
import json
import tempfile


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.fleet.cli",
        description="Fault-tolerant ensemble scheduler for repro_torch.solvers.")
    ap.add_argument("--case", default="heat",
                    help="solver case every job runs (default: heat)")
    ap.add_argument("--n", type=int, default=16, help="cubic grid extent N")
    ap.add_argument("--steps", type=int, default=4, help="Δt steps per job")
    ap.add_argument("--jobs", type=int, default=4,
                    help="ensemble size when --sweep is not given; members "
                         "differ by initial-condition amplitude")
    ap.add_argument("--sweep", default="",
                    help="key=v1,v2,... — one job per swept physics value "
                         "(e.g. kappa=0.05,0.1,0.2)")
    ap.add_argument("--submesh", default="2x1",
                    help="PUxPV submesh each job runs on (default 2x1)")
    ap.add_argument("--slots", type=int, default=8,
                    help="device-slot pool the controller packs jobs into")
    ap.add_argument("--dt", type=float, default=None)
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every job (default cuda; cpu for "
                         "a CPU run)")
    ap.add_argument("--ckpt-every", type=int, default=2,
                    help="checkpoint cadence in steps (default 2)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="per-job retry budget before quarantine")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="per-attempt deadline in seconds (timeout class)")
    ap.add_argument("--inject", default="",
                    help="fault spec (see repro_torch.fleet.faults): e.g. "
                         "'kill-at-step:3' or "
                         "'slow-at-step:2:30@job=job1;kill-at-step:1'")
    ap.add_argument("--reshape-on-retry", default="",
                    help="comma list of PUxPV shapes retries cycle through "
                         "(elastic restore), e.g. '1x2,2x1'")
    ap.add_argument("--workdir", default="",
                    help="campaign dir for specs/logs/checkpoints/reports "
                         "(default: a fresh temp dir)")
    ap.add_argument("--report", default="",
                    help="write the fleet-report/v1 JSON here")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--trace", dest="trace_path", default="",
                    help="write a Chrome-trace JSON of the fleet.* counters")
    return ap


def _parse_shapes(text: str) -> tuple:
    shapes = []
    for tok in text.split(","):
        tok = tok.strip()
        if not tok:
            continue
        try:
            pu, pv = (int(t) for t in tok.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--reshape-on-retry wants PUxPV shapes, "
                             f"got {tok!r}")
        shapes.append((pu, pv))
    return tuple(shapes)


def build_jobs(args) -> list:
    from repro_torch.fleet.controller import FleetJob

    try:
        pu, pv = (int(t) for t in args.submesh.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--submesh must look like 2x2, got {args.submesh!r}")
    common = dict(case=args.case, n=args.n, steps=args.steps, mesh=(pu, pv),
                  dt=args.dt, dtype=args.dtype, device=args.device)
    if args.sweep:
        key, _, vals = args.sweep.partition("=")
        if not key or not vals:
            raise SystemExit(f"--sweep wants key=v1,v2,..., got {args.sweep!r}")
        return [FleetJob(job_id=f"job{i}", params={key: float(v)}, **common)
                for i, v in enumerate(vals.split(","))]
    if args.jobs < 1:
        raise SystemExit(f"--jobs must be >= 1, got {args.jobs}")
    # replicas at staggered amplitudes: distinct trajectories, one physics
    return [FleetJob(job_id=f"job{i}", scale=1.0 + 0.25 * i, **common)
            for i in range(args.jobs)]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from repro_torch import obs
    from repro_torch.device import resolve_device
    resolve_device(args.device)     # no card for "cuda": raise, launch nothing
    if args.trace_path:
        obs.clear()
        obs.enable()

    from repro_torch.fleet.controller import FleetController
    jobs = build_jobs(args)
    workdir = args.workdir or tempfile.mkdtemp(prefix="repro-fleet-")
    try:
        ctl = FleetController(
            jobs, workdir=workdir, total_slots=args.slots,
            max_retries=args.max_retries, timeout_s=args.timeout,
            ckpt_every=args.ckpt_every, fault_spec=args.inject,
            reshape_on_retry=_parse_shapes(args.reshape_on_retry),
            verbose=not args.quiet)
    except ValueError as e:
        raise SystemExit(f"invalid fleet config: {e}")

    print(f"fleet: {len(jobs)} x {args.case} N={args.n}^3 steps={args.steps} "
          f"on {args.submesh} submeshes over {args.slots} slots "
          f"(retries={args.max_retries}"
          f"{', inject ' + args.inject if args.inject else ''})", flush=True)
    results = ctl.run()

    for jid in sorted(results):
        res = results[jid]
        final = res.final_observables()
        tail = ("  ".join(f"{k}={v:.6e}" for k, v in sorted(final.items())
                          if k != "t") if final else "no observables")
        print(f"  {jid}: {res.status} ({res.attempts} attempt(s), "
              f"{len(res.failures)} failure(s))  {tail}")
    print("counters: " + "  ".join(
        f"{k.split('fleet.')[-1]}={int(v)}"
        for k, v in sorted(ctl.counters.items())))

    if args.report:
        with open(args.report, "w") as f:
            json.dump(ctl.report(results), f, indent=1)
        print(f"wrote report {args.report}")
    if args.trace_path:
        obs.disable()
        obs.write_chrome_trace(args.trace_path, obs.tracer, obs.metrics)
        print(f"wrote trace {args.trace_path}")
    return 0 if all(r.ok for r in results.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
