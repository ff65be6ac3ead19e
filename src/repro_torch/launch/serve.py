"""LM serving entry point of the port: batched prefill, then greedy decode
over a KV cache.

Port of the LM mode of ``repro.launch.serve``, with the same flags plus
``--device`` (default ``cuda``; raises without a card) and ``--dtype``
(overrides the config's ``compute_dtype``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --batch 8 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --smoke --device cpu

The weights are random, from seed 0; the prompt tokens are those of
``repro.launch.serve`` (``numpy.random.RandomState(0)``).  Prints the
prefill time, the decode time and rate, and a sample; returns the
(B, gen) tokens.  The prefill's attention is the flash-attention kernel.

``--mesh DATAxMODEL`` other than ``1x1`` serves in one rank process a
device of the mesh (:func:`repro_torch.launch.mesh.run_on_mesh`): the
parameters sharded by the reference's specs, the batch's rows over
``data``, the decode cache laid out by ``cache_specs`` (its kv heads, or
else its head_dim, over ``model``); rank 0 prints::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --device cpu --mesh 2x2

``--sim`` serves spectral simulations instead: every other argument goes
to :mod:`repro_torch.serving.cli` (the batched solver server)::

    PYTHONPATH=src python -m repro_torch.launch.serve --sim --case heat \\
        --n 16 --mesh 2x2 --requests 4 --max-batch 2 --validate --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch import mesh as M
from repro_torch.models.transformer import (RunCfg, check_supported, decode_step,
                                            full_vocab, gather_rows, local_rows,
                                            prefill)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_tokens(cfg, b: int, s: int, device, seed: int = 0) -> torch.Tensor:
    """``repro.launch.serve``'s prompt: ``RandomState(seed).randint(0, vocab, (b, s))``."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, cfg.vocab, (b, s))).to(device)


def generate(cfg, run: RunCfg, model, tokens: torch.Tensor, gen: int, *,
             forced: torch.Tensor | None = None, keep_logits: bool = False):
    """Prefill ``tokens`` (B, S), then ``gen - 1`` greedy decode steps: gen
    tokens in all.  ``forced`` (B, gen) feeds those tokens instead of the
    greedy ones (teacher forcing).  Returns a dict: ``tokens`` (B, gen),
    the greedy choices; ``logits``, the prefill's last-position logits and
    each step's, when ``keep_logits``; ``prefill_ms`` and ``decode_ms`` on
    the host clock, synchronised with the device.  On a mesh (collective)
    ``tokens`` and ``forced`` are the global batch, each rank serves its
    rows (its cache holds them), and the results are the global batch's on
    every rank; ``cache`` is this rank's."""
    dev = tokens.device
    s = tokens.shape[1]
    tokens = local_rows(tokens, run)
    if forced is not None:
        forced = local_rows(forced, run)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, run, model, {"tokens": tokens}, t_max=s + gen)
    logits = full_vocab(cfg, run, logits)
    tok = logits[:, -1].argmax(-1)[:, None]
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out, kept = [tok], [logits] if keep_logits else []
    t0 = time.perf_counter()
    for i in range(gen - 1):
        feed = tok if forced is None else forced[:, i:i + 1]
        logits, cache = decode_step(cfg, run, model, cache, feed)
        logits = full_vocab(cfg, run, logits)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
        if keep_logits:
            kept.append(logits)
    _sync(dev)
    decode_ms = (time.perf_counter() - t0) * 1e3
    return {"tokens": gather_rows(torch.cat(out, dim=1), run),
            "logits": [gather_rows(x, run) for x in kept], "cache": cache,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms}


def serve(args, ctx=None) -> torch.Tensor:
    """The LM serving run of ``args`` in this process: on one device, or
    with ``ctx`` (a rank of the mesh ``args.mesh``) as one rank of it.
    Returns the (B, gen) tokens."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.dtype)
    check_supported(cfg)
    run, model, device = M.rank_setup(cfg, ctx, args.device)
    b, s = args.batch, args.prompt_len
    tokens = prompt_tokens(cfg, b, s, device)
    r = generate(cfg, run, model, tokens, args.gen)
    if ctx is None or ctx.rank == 0:
        dt = r["decode_ms"] / 1e3
        print(f"prefill {s} tokens x{b}: {r['prefill_ms']:.1f} ms")
        print(f"decode  {args.gen - 1} steps: {r['decode_ms']:.1f} ms "
              f"({(args.gen - 1) * b / max(dt, 1e-9):.1f} tok/s)")
        print("sample:", r["tokens"][0, :16].cpu().numpy(), flush=True)
    # a rank's result crosses to the parent pickled: numpy, not a tensor
    return r["tokens"].cpu().numpy() if ctx is not None else r["tokens"]


def _rank_main(ctx, argv):
    return serve(parse_args(argv), ctx)


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="LM serving of the PyTorch/CUDA port (batched "
                    "prefill + greedy decode); --sim switches to the batched "
                    "spectral-simulation server (repro_torch.serving.cli "
                    "flags apply).")
    ap.add_argument("--sim", action="store_true",
                    help="serve spectral simulations instead of LM tokens "
                         "(remaining args go to repro_torch.serving.cli)")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL (e.g. 2x2)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--dtype", default=None,
                    help="compute dtype overriding the config's (e.g. float32)")
    return ap.parse_args(argv)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--sim" in argv:
        argv.remove("--sim")
        from repro_torch.serving.cli import main as sim_main
        return sim_main(argv)
    args = parse_args(argv)
    dm, mm = M.parse_mesh_arg(args.mesh)
    if dm * mm == 1:
        return serve(args)
    return torch.from_numpy(M.run_on_mesh(
        _rank_main, {"data": dm, "model": mm}, device=args.device,
        args=(argv,))[0])


if __name__ == "__main__":
    main()
