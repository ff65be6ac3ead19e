"""Train a small LM on the port for a few hundred steps (end-to-end
driver), optionally sharded over a mesh of rank processes.

    PYTHONPATH=src python examples_torch/train_lm.py --steps 200
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu --steps 30 \\
        --mesh 2x2

smollm-360m's reduced config (2 layers, d 60), the deterministic synthetic
pipeline, AdamW, checkpoints every 50 steps, the loss curve printed.  Loss
must drop from ~ln(V).
"""

import argparse
import math
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL (e.g. 2x2)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if not args.ckpt_dir:
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_lm_")

    losses = train_main([
        "--arch", "smollm-360m", "--smoke",
        "--steps", str(args.steps), "--batch", "16", "--seq", "128",
        "--lr", "1e-3", "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
        "--mesh", args.mesh, "--device", args.device,
    ])
    first, last = losses[0], sum(losses[-10:]) / 10
    print(f"loss: {first:.3f} -> {last:.3f} (ln V = {math.log(512):.3f})")
    # short runs only need a downward trend; the 200-step run drops well
    # past 0.5 nats
    want = 0.5 if args.steps >= 150 else 0.02
    assert last < first - want, f"loss should fall by >{want} nats"


if __name__ == "__main__":
    main()
