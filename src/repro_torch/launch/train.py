"""Training entry point of the port, with checkpoint/restart fault tolerance.

Port of ``repro.launch.train``, with the same flags plus ``--device``
(default ``cuda``; raises without a card) and ``--seed`` (the init seed, 0
as the reference's ``PRNGKey(0)``; the values differ)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 100 --batch 8 --seq 512 --ckpt-dir build/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 12 --batch 4 --seq 64 --log-every 1
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 12 --batch 4 --seq 64 --mesh 2x2

It prints the reference's lines (``step N loss … gnorm … lr …``,
``[resume] from step N``, ``[halt] …``, ``[done] …``) and returns the
losses.  Resume is automatic: if the checkpoint directory has a LATEST
pointer, training continues from it.  Checkpoints hold ``(params,
opt_state)`` in the JAX trainer's tree and keys (:func:`train_tree`), so
either package resumes the other's, on any mesh.  The data are
:mod:`repro_torch.data.pipeline`'s, bitwise the reference's.

``--mesh DATAxMODEL`` other than ``1x1`` trains in one rank process a
device of the mesh (:func:`repro_torch.launch.mesh.run_on_mesh`; several
ranks may share one card): FSDP over ``data``, tensor parallelism over
``model`` (:mod:`repro_torch.models.transformer`); each rank takes its
rows of the global batch, rank 0 prints, gathers and writes the
checkpoints, and every rank restores its shards.  ``--grad-compression``
does what the reference's does on such a mesh: nothing (it has no
``pod`` axis, so the step is the plain one).  The architectures other
than the dense uniform decoders are not ported yet (ROADMAP Queue 1 item
11).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.models.convert import params_to_jax_tree, port_leaves, put_path
from repro_torch.models.transformer import (RunCfg, check_supported, init_model,
                                            param_specs)
from repro_torch.optim import adamw
from repro_torch.training.train_loop import TrainCfg, make_train_step


def _groups(names) -> list:
    """The parameter names in gather groups: the top-level leaves, then
    each block's."""
    groups: dict = {}
    for n in names:
        key = ".".join(n.split(".")[:2]) if n.startswith("blocks.") else ""
        groups.setdefault(key, []).append(n)
    return list(groups.values())


def train_tree(model, opt_state, run: RunCfg | None = None) -> tuple | None:
    """``(params, opt_state)`` in the JAX trainer's tree: the parameters
    and each moment as :func:`params_to_jax_tree` lays them out, and the
    int32 ``count``.  On a mesh (collective) the whole leaves, gathered a
    block at a time onto the host of rank 0, which gets the tree; the
    other ranks get None."""
    named = dict(model.named_parameters())
    if run is None or run.mesh is None:
        return (params_to_jax_tree(named),
                {"m": params_to_jax_tree(opt_state["m"]),
                 "v": params_to_jax_tree(opt_state["v"]),
                 "count": opt_state["count"]})
    specs = param_specs(model.cfg, run.mesh)
    root = all(c == 0 for c in run.mesh.coords.values())
    full = {"p": {}, "m": {}, "v": {}}
    for names in _groups(named):
        for key, src in (("p", named), ("m", opt_state["m"]), ("v", opt_state["v"])):
            got = C.gather_full({n: src[n].detach() for n in names},
                                {n: specs[n] for n in names})
            if root:
                full[key].update({n: t.to("cpu", copy=True) for n, t in got.items()})
    if not root:
        return None
    return (params_to_jax_tree(full["p"]),
            {"m": params_to_jax_tree(full["m"]), "v": params_to_jax_tree(full["v"]),
             "count": opt_state["count"].to("cpu", copy=True)})


def _placers(model, run: RunCfg, device) -> dict:
    """A tree of :func:`train_tree`'s parameter layout whose leaves cut
    this rank's shard of a whole (numpy) leaf onto ``device``."""
    specs = param_specs(model.cfg, run.mesh)

    def placer(spec):
        return lambda a: torch.from_numpy(
            np.ascontiguousarray(SH.shard_of(a, spec, run.mesh))).to(device)

    tree: dict = {}
    for name, spec in specs.items():
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            if i == "0":
                put_path(tree, ["blocks"] + rest.split("."), placer((None,) + spec))
            continue
        put_path(tree, name.split("."), placer(spec))
    return tree


def restore_train_state(ckpt: CheckpointManager, model, opt_state,
                        step: int | None = None, run: RunCfg | None = None) -> dict:
    """Load a checkpoint of :func:`train_tree`'s layout (the latest, or
    ``step``) into ``model`` and ``opt_state`` in place (on a mesh, this
    rank's shards of it); returns its manifest."""
    # the whole leaves' shapes (on a mesh the model holds shards)
    params = dict(init_model(model.cfg, device="meta").named_parameters())
    mdt = next(iter(opt_state["m"].values())).dtype
    moment = {n: torch.empty(p.shape, dtype=mdt, device="meta")
              for n, p in params.items()}
    template = (params_to_jax_tree(params),
                {"m": params_to_jax_tree(moment), "v": params_to_jax_tree(moment),
                 "count": torch.empty((), dtype=torch.int32, device="meta")})
    place = None
    if run is not None and run.mesh is not None:
        dev = next(model.parameters()).device
        pl = _placers(model, run, dev)
        place = (pl, {"m": pl, "v": pl})
    (params, state), meta = ckpt.restore(template, step=step, place=place)
    with torch.no_grad():
        for dst, src in ((dict(model.named_parameters()), params),
                         (opt_state["m"], state["m"]), (opt_state["v"], state["v"])):
            leaves = port_leaves(src)
            for name, t in dst.items():
                t.copy_(leaves[name])
        opt_state["count"] = state["count"].to(opt_state["count"].device)
    return meta


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL (e.g. 2x2)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--halt-after", type=int, default=0,
                    help="simulate a crash: exit after N steps (schedule and "
                         "data are still configured for --steps)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="init seed")
    return ap.parse_args(argv)


def train(args, ctx=None) -> list:
    """The training run of ``args`` (:func:`parse_args`) in this process:
    on one device, or with ``ctx`` (a :class:`repro_torch.dist.RankContext`
    whose grid is ``args.mesh``) as one rank of the mesh.  Returns the
    losses."""
    cfg = get_config(args.arch, smoke=args.smoke)
    check_supported(cfg)
    run, model, device = M.rank_setup(cfg, ctx, args.device, seed=args.seed,
                                      remat=cfg.remat)
    lead = ctx is None or ctx.rank == 0
    acfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                             warmup_steps=max(args.steps // 20, 5),
                             moment_dtype=cfg.opt_state_dtype)
    tcfg = TrainCfg(microbatches=args.microbatches, adamw=acfg,
                    grad_compression=args.grad_compression)
    opt_state = adamw.init(acfg, dict(model.named_parameters()))

    start = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and ckpt.latest_step() is not None:
        meta = restore_train_state(ckpt, model, opt_state, run=run)
        start = meta["step"] + 1
        if lead:
            print(f"[resume] from step {meta['step']}")

    # the dense decoders read tokens (check_supported refuses embeds, frames)
    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                               global_batch=args.batch))
    step_fn = make_train_step(cfg, run, tcfg)

    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.batch_for_step(step).items()}
        _, metrics = step_fn(model, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if ckpt and (step % args.ckpt_every == 0 or step == args.steps - 1):
            tree = train_tree(model, opt_state, run)
            if lead:
                ckpt.save(step, tree, meta={"arch": args.arch})
        if args.halt_after and step + 1 >= args.halt_after:
            if ckpt and lead:
                ckpt.wait()
            if lead:
                print(f"[halt] simulated crash after step {step}", flush=True)
            return losses
    if ckpt and lead:
        ckpt.wait()
    if lead:
        print(f"[done] first loss {losses[0]:.4f} last loss {losses[-1]:.4f}",
              flush=True)
    return losses


def _rank_main(ctx, argv):
    return train(parse_args(argv), ctx)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    dm, mm = M.parse_mesh_arg(args.mesh)
    if dm * mm == 1:
        return train(args)
    return M.run_on_mesh(_rank_main, {"data": dm, "model": mm}, device=args.device,
                         args=(argv,))[0]


if __name__ == "__main__":
    main()
