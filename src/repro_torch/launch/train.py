"""Training entry point of the port, with checkpoint/restart fault tolerance.

Port of ``repro.launch.train`` on one device, with the same flags plus
``--device`` (default ``cuda``; raises without a card) and ``--seed`` (the
init seed, 0 as the reference's ``PRNGKey(0)``; the values differ)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 100 --batch 8 --seq 512 --ckpt-dir build/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 12 --batch 4 --seq 64 --log-every 1

It prints the reference's lines (``step N loss … gnorm … lr …``,
``[resume] from step N``, ``[halt] …``, ``[done] …``) and returns the
losses.  Resume is automatic: if the checkpoint directory has a LATEST
pointer, training continues from it.  Checkpoints hold ``(params,
opt_state)`` in the JAX trainer's tree and keys
(:func:`train_tree`), so either package resumes the other's.  The data
are :mod:`repro_torch.data.pipeline`'s, bitwise the reference's.

A mesh other than ``1x1``, ``--grad-compression`` and the architectures
other than the dense uniform decoders are not ported yet (ROADMAP Queue 1
item 11).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.device import resolve_device
from repro_torch.models.convert import params_to_jax_tree, port_leaves
from repro_torch.models.transformer import (LM_ITEM, RunCfg, check_supported,
                                            init_model)
from repro_torch.optim import adamw
from repro_torch.training.train_loop import TrainCfg, make_train_step


def train_tree(model, opt_state) -> tuple:
    """``(params, opt_state)`` in the JAX trainer's tree: the parameters
    and each moment as :func:`params_to_jax_tree` lays them out, and the
    int32 ``count``."""
    return (params_to_jax_tree(model.named_parameters()),
            {"m": params_to_jax_tree(opt_state["m"]),
             "v": params_to_jax_tree(opt_state["v"]),
             "count": opt_state["count"]})


def restore_train_state(ckpt: CheckpointManager, model, opt_state,
                        step: int | None = None) -> dict:
    """Load a checkpoint of :func:`train_tree`'s layout (the latest, or
    ``step``) into ``model`` and ``opt_state`` in place; returns its
    manifest."""
    params = {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
              for n, p in model.named_parameters()}
    moment = {n: torch.empty(m.shape, dtype=m.dtype, device="meta")
              for n, m in opt_state["m"].items()}
    template = (params_to_jax_tree(params),
                {"m": params_to_jax_tree(moment), "v": params_to_jax_tree(moment),
                 "count": torch.empty((), dtype=torch.int32, device="meta")})
    (params, state), meta = ckpt.restore(template, step=step)
    with torch.no_grad():
        for dst, src in ((dict(model.named_parameters()), params),
                         (opt_state["m"], state["m"]), (opt_state["v"], state["v"])):
            leaves = port_leaves(src)
            for name, t in dst.items():
                t.copy_(leaves[name])
        opt_state["count"] = state["count"].to(opt_state["count"].device)
    return meta


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL; only 1x1")
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
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        raise NotImplementedError(f"--mesh {args.mesh}: the port trains on one "
                                  f"device; sharding is not ported yet ({LM_ITEM})")
    if args.grad_compression:
        raise NotImplementedError("--grad-compression syncs gradients across "
                                  f"pods of a mesh; not ported yet ({LM_ITEM})")

    cfg = get_config(args.arch, smoke=args.smoke)
    check_supported(cfg)
    device = resolve_device(args.device)
    run = RunCfg(remat=cfg.remat)
    model = init_model(cfg, seed=args.seed, device=device)
    acfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                             warmup_steps=max(args.steps // 20, 5),
                             moment_dtype=cfg.opt_state_dtype)
    tcfg = TrainCfg(microbatches=args.microbatches, adamw=acfg)
    opt_state = adamw.init(acfg, dict(model.named_parameters()))

    start = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and ckpt.latest_step() is not None:
        meta = restore_train_state(ckpt, model, opt_state)
        start = meta["step"] + 1
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
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if ckpt and (step % args.ckpt_every == 0 or step == args.steps - 1):
            ckpt.save(step, train_tree(model, opt_state), meta={"arch": args.arch})
        if args.halt_after and step + 1 >= args.halt_after:
            if ckpt:
                ckpt.wait()
            print(f"[halt] simulated crash after step {step}")
            return losses
    if ckpt:
        ckpt.wait()
    print(f"[done] first loss {losses[0]:.4f} last loss {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
