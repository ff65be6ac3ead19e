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
else its head_dim, over ``model``); rank 0 prints.  qwen3-moe's experts
lie over ``model``, its dispatch and combine all-to-alls over it
(:mod:`repro_torch.models.moe`); deepseek-v2-lite's MLA cuts its heads
over ``model`` and keeps the compressed cache (c_kv and k_rope a token,
:mod:`repro_torch.models.mla`) whole there; a batch whose rows do not
divide over ``data`` lies whole on every rank.  rwkv6-3b (RWKV-6,
:mod:`repro_torch.models.rwkv`) decodes from an O(1) state a layer, its
recurrence the ``wkv6`` kernel; its cache has no time axis, so a long
prompt costs the prefill's time and nothing in the decode's memory.  On
a mesh each rank computes its heads and holds their WKV state::

    PYTHONPATH=src python3 -m repro_torch.launch.serve --arch rwkv6-3b \
        --batch 1 --prompt-len 524288 --gen 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --smoke --device cpu --mesh 2x2

jamba-1.5-large-398b (the Jamba hybrid: Mamba and attention 7:1, its
recurrence the ``selective_scan`` kernel, :mod:`repro_torch.models.mamba`)
serves on one device.  Its one superblock (8 layers, 45.2 B parameters)
does not fit an 80 GB card at full width; ``--experts FIRST:COUNT`` serves
from one card's share of every MoE layer's experts, the deployment that
puts each MoE layer's 16 experts over 2 chips, expert-parallel, everything
else whole on both (this card holds 8: ``--experts 0:8``); each MoE layer
gives the held experts' part of its output::

    PYTHONPATH=src python3 -m repro_torch.launch.serve --arch jamba-1.5-large-398b \
        --layers 8 --experts 0:8 --batch 8 --prompt-len 2048 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-1.5-large-398b \
        --smoke --device cpu

The int8 KV cache and the sequence-sharded decode take no flag, as in the
reference: :func:`generate` serves a config with ``kv_quant`` from an int8
cache (``dataclasses.replace(cfg, kv_quant=True)``), and on a mesh a
``RunCfg`` with ``seq_shard_kv`` cuts the cache's time axis over ``data``
(the batch then whole on every rank)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --device cpu --mesh 2x2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
        --smoke --device cpu --mesh 2x2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \
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
from repro_torch.models.transformer import (RunCfg, batch_run, check_supported,
                                            decode_step, full_vocab, gather_rows,
                                            local_rows, prefill)


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
    tokens in all (the cache sized for S + gen positions; an RWKV state
    has none).  ``forced`` (B, gen) feeds those tokens instead of the
    greedy ones (teacher forcing).  Returns a dict: ``tokens`` (B, gen),
    the greedy choices; ``logits``, the prefill's last-position logits and
    each step's, when ``keep_logits``; ``prefill_ms`` and ``decode_ms`` on
    the host clock, synchronised with the device.  On a mesh (collective)
    ``tokens`` and ``forced`` are the global batch, each rank serves its
    rows (its cache holds them), and the results are the global batch's on
    every rank; ``cache`` is this rank's.  A batch whose rows do not
    divide over the data axes lies whole on every rank (``batch_run``)."""
    dev = tokens.device
    s = tokens.shape[1]
    run = batch_run(run, tokens.shape[0])
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
    cfg = _config(args)
    check_supported(cfg, mesh=ctx is not None)
    run, model, device = M.rank_setup(cfg, ctx, args.device, experts=args.experts)
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


def _config(args):
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.dtype)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


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
    ap.add_argument("--layers", type=int, default=0,
                    help="bring-up runs only: serve the config cut to its first N "
                         "layers, full width (0: all of them; the reference's "
                         "launcher has no such option)")
    ap.add_argument("--experts", type=M.parse_experts_arg, default=None, metavar="FIRST:COUNT",
                    help="hold only this block of every MoE layer's experts, one "
                         "card's share of an expert-parallel deployment (one "
                         "device; default: all)")
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
    check_supported(_config(args), mesh=True)
    return torch.from_numpy(M.run_on_mesh(
        _rank_main, {"data": dm, "model": mm}, device=args.device,
        args=(argv,))[0])


if __name__ == "__main__":
    main()
