"""One supervised fleet worker: a solver job with checkpoints and faults.

    python -m repro_torch.fleet.worker --spec job.spec.json --attempt 0

Port of ``repro.fleet.worker``: the same spec document (written by
:class:`repro_torch.fleet.controller.FleetController`), progress log,
result document and exit codes.  The worker is the unit the controller
kills, restarts and quarantines.  It reads the job spec, builds the solver
on the spec's ``device`` (default ``"cuda"``; without a card that raises,
and the attempt fails: nothing falls back to the CPU), and then either
starts from t=0 (applying the job's initial-condition ``scale``) or, if
the job's checkpoint directory has a complete snapshot, resumes
mid-trajectory via ``SpectralSolver.restore_state`` (elastic: the snapshot
may have been written on another grid).

**Grid.**  A 1×1 submesh runs in the worker process.  A larger one runs in
its rank processes (:func:`repro_torch.dist.run_ranks`; on one card they
share it), each of which builds the solver on its block:

* ``SpectralSolver.state_tree`` is collective and gives the tree to rank 0
  alone, so rank 0 alone saves (and only its manager is armed by a
  ``torn-checkpoint``); every rank restores from the same snapshot, which
  a dead earlier attempt can no longer be writing;
* the observables are all-reduced, so rank 0 alone writes the progress
  log and the result document;
* an invalid spec makes every rank raise the same error in
  ``make_solver``; each returns ``POISON_EXIT`` as its result, never as a
  crash;
* ``kill-at-step:N`` fires in every rank after step N: rank 0 drains its
  snapshot, the ranks pass a barrier, and each exits ``KILL_EXIT``; the
  worker reads the ranks' exit codes (:class:`repro_torch.dist.
  RankFailure`) and exits ``KILL_EXIT`` itself.  Any other rank failure
  exits 1, a crash to the controller.

Per step rank 0 appends one JSON line ``{"step", "attempt", "obs"}`` to the
job's shared progress log (flushed immediately, so a hard kill loses at
most a torn final line) and snapshots through ``CheckpointManager`` every
``ckpt_every`` steps.  On success it writes the result document atomically
and the worker exits 0.  ``restore_latency_us`` is rank 0's time in
``restore_state``.

Faults come from ``REPRO_FAULT_SPEC`` (see :mod:`repro_torch.fleet.faults`)
and are filtered by (job, attempt) before anything fires: deterministic by
construction.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _write_json_atomic(path: str, doc: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:
                pass
    return total


def _run(spec: dict, attempt: int, active: list, grid, device, rank: int = 0) -> int:
    """The job on ``grid`` in this process (rank ``rank`` of the grid's
    ranks); returns the worker's exit code, or exits ``KILL_EXIT``."""
    import torch.distributed as tdist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.fleet import faults as fl
    from repro_torch.fleet.records import KILL_EXIT, POISON_EXIT
    from repro_torch.serving.server import scaled_initial_fields
    from repro_torch.solvers import make_solver
    from repro_torch.solvers.base import SolverState

    job_id = spec["job_id"]
    lead = rank == 0
    try:
        kwargs = dict(spec.get("params") or {})
        if spec.get("dt") is not None:
            kwargs["dt"] = spec["dt"]
        n = spec["n"] if isinstance(spec["n"], int) else tuple(spec["n"])
        solver = make_solver(spec["case"], grid, n, device=device,
                             dtype=spec["dtype"], plan_cfg=spec.get("plan_cfg"),
                             **kwargs)
    except (ValueError, TypeError) as e:
        # poison config: deterministically invalid (on every rank alike) —
        # tell the controller not to waste retries on it
        if lead:
            print(f"[poison] {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return POISON_EXIT

    mgr = CheckpointManager(spec["ckpt_dir"], keep=spec.get("keep", 2))
    if lead:
        for fault in active:
            if fault.kind == "torn-checkpoint":
                fl.arm_torn_checkpoint(mgr, at_step=fault.step)
    kill = next((f for f in active if f.kind == "kill-at-step"), None)
    slow = next((f for f in active if f.kind == "slow-at-step"), None)

    restore_us = 0.0
    if mgr.latest_step() is not None:
        t0 = time.monotonic()
        state, meta = solver.restore_state(mgr)
        restore_us = (time.monotonic() - t0) * 1e6
        if lead:
            print(f"[resume] job {job_id} from step {state.n_steps} "
                  f"(saved on mesh {meta.get('mesh')}, "
                  f"{restore_us / 1e3:.1f} ms restore)", flush=True)
    else:
        state = SolverState(
            fields=scaled_initial_fields(solver, spec.get("scale", 1.0)))

    progress = open(spec["progress_path"], "a") if lead else None

    def emit(step: int, observables: dict) -> None:
        if progress is not None:
            progress.write(json.dumps({"step": step, "attempt": attempt,
                                       "obs": observables}) + "\n")
            progress.flush()

    steps = int(spec["steps"])
    every = int(spec.get("ckpt_every", 2))
    ckpt_meta = {"job_id": job_id, "case": spec["case"],
                 "mesh": [grid.pu, grid.pv], "attempt": attempt}

    def save(step: int, block: bool = False) -> None:
        tree = solver.state_tree(state)        # collective; rank 0's alone
        if tree is not None:
            mgr.save(step, tree, meta=ckpt_meta, block=block)

    if state.n_steps == 0:
        emit(0, solver.observables(state))
    for i in range(state.n_steps + 1, steps + 1):
        state = solver.step(state)
        emit(i, solver.observables(state))
        if every and i % every == 0 and i < steps:
            save(i)
        if slow and i == slow.step:
            if lead:
                print(f"[fault] slow-at-step {i}: sleeping {slow.seconds:g}s",
                      flush=True)
            time.sleep(slow.seconds)
        if kill and i == kill.step:
            # hard exit skipping every cleanup path (progress close, result
            # write, atexit) — but drain the in-flight snapshot first, so
            # whether the retry resumes is a function of (step, ckpt_every)
            # alone, not of writer-thread timing; the mid-write-tear case
            # is injected deterministically via torn-checkpoint instead
            if lead:
                try:
                    mgr.wait()
                except Exception:
                    pass
            if grid.p > 1:
                tdist.barrier()                # the snapshot has landed
            if lead:
                print(f"[fault] kill-at-step {i}", flush=True)
            os._exit(KILL_EXIT)
    # final snapshot; block so a swallowed async write error becomes a crash
    save(steps, block=True)
    if not lead:
        return 0
    progress.close()
    _write_json_atomic(spec["result_path"], {
        "job_id": job_id, "attempt": attempt, "final_step": steps,
        "restore_latency_us": round(restore_us, 1),
        "checkpoint_bytes": _dir_bytes(spec["ckpt_dir"]),
    })
    print(f"[done] job {job_id}: {steps} steps "
          f"(attempt {attempt})", flush=True)
    return 0


def _rank_main(ctx, spec: dict, attempt: int, active: list) -> int:
    """The job in one rank process of its grid."""
    return _run(spec, attempt, active, ctx.grid(), ctx.device, rank=ctx.rank)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.fleet.worker")
    ap.add_argument("--spec", required=True, help="job spec JSON path")
    ap.add_argument("--attempt", type=int, default=0)
    args = ap.parse_args(argv)

    with open(args.spec) as f:
        spec = json.load(f)
    from repro_torch.fleet import faults as fl
    from repro_torch.fleet.records import KILL_EXIT, POISON_EXIT
    active = fl.plan_from_env().active(spec["job_id"], args.attempt)

    from repro_torch import dist
    from repro_torch.core.decomposition import PencilGrid

    device = spec.get("device", "cuda")
    try:
        pu, pv = (int(d) for d in spec["mesh"])
        grid = PencilGrid.from_mesh(pu, pv)
    except (ValueError, TypeError) as e:
        print(f"[poison] {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return POISON_EXIT
    if grid.p == 1:
        return _run(spec, args.attempt, active, grid, device)
    try:
        rcs = dist.run_ranks(_rank_main, pu, pv, device=device,
                             args=(spec, args.attempt, active))
    except dist.RankFailure as e:
        print(f"[ranks] {e} (exit codes {e.exit_codes})", file=sys.stderr,
              flush=True)
        return KILL_EXIT if KILL_EXIT in e.exit_codes.values() else 1
    return rcs[0]


if __name__ == "__main__":
    raise SystemExit(main())
