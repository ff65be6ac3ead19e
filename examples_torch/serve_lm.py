"""Serve a small model with batched requests on the port: prefill, then
greedy decode, on one device and sharded over a 2x2 mesh of rank
processes (the same tokens).

    PYTHONPATH=src python examples_torch/serve_lm.py               # on the card
    PYTHONPATH=src python examples_torch/serve_lm.py --device cpu
"""

import argparse

import torch

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2x2", help="DATAxMODEL of the sharded run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    common = ["--arch", "smollm-360m", "--smoke", "--batch", "4",
              "--prompt-len", "32", "--gen", "16", "--device", args.device]
    one = serve_main(common)
    sharded = serve_main(common + ["--mesh", args.mesh])
    assert one.shape == (4, 16)
    assert torch.equal(one.cpu(), sharded.cpu()), "the sharded run's tokens differ"
    print("serve_lm OK")


if __name__ == "__main__":
    main()
