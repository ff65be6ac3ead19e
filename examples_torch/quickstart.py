"""Quickstart of the PyTorch/CUDA port: the paper's distributed 3D FFT.

    PYTHONPATH=src python examples_torch/quickstart.py            # on the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

A real field through ``repro_torch.make_fft3d`` on one rank, held against
numpy, then forward + inverse on a 2x2 pencil grid of rank processes
(``repro_torch.dist.run_ranks``) on every engine: the switched
all-to-all, the torus ring, the compute-overlapped ring and the NIC
engine's ring, each rank's roundtrip held against its block of the field.
"""

import argparse

import numpy as np
import torch

from repro_torch import dist
from repro_torch.core.decomposition import PencilGrid
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.core.fft3d import make_fft3d

ENGINES = ("switched", "torus", "overlap_ring", "pallas_ring")


def _field(n):
    return np.random.RandomState(0).randn(n, n, n)     # (y, z, x) X-pencil


def _roundtrips(ctx, n):
    """Each engine's forward + inverse on this rank's block of the field."""
    grid = ctx.grid()
    u, v = grid.coords
    ny, nz = n // grid.pu, n // grid.pv
    block = torch.from_numpy(_field(n)[u * ny:(u + 1) * ny, v * nz:(v + 1) * nz])
    errs = {}
    for engine in ENGINES:
        fwd, inv, plan = make_fft3d(grid, n, device=ctx.device,
                                    spec=EngineSpec(engine=engine, real=True))
        x = block.to(ctx.device)
        back = inv(*fwd(x))
        errs[engine] = float((back - x).norm() / x.norm())
    return errs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--mesh", default="2x2", help="Pu x Pv of the rank grid")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    n = args.n
    field = _field(n)
    fwd, _, plan = make_fft3d(PencilGrid.from_mesh(1, 1), n, device=args.device,
                              spec=EngineSpec(real=True))
    kr, ki = fwd(torch.from_numpy(field).to(args.device))
    keep = n // 2 + 1
    want = np.fft.fftn(np.fft.rfft(field, axis=2), axes=(0, 1)).transpose(2, 0, 1)
    got = (kr.cpu().numpy() + 1j * ki.cpu().numpy())[:keep]
    err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    print(f"1x1 forward against numpy: rel-err {err:.2e}")
    assert err < 1e-10
    pu, pv = (int(t) for t in args.mesh.split("x"))
    errs = dist.run_ranks(_roundtrips, pu, pv, device=args.device, args=(n,))
    for engine in ENGINES:
        worst = max(e[engine] for e in errs)
        print(f"engine={engine:12s} {args.mesh} roundtrip rel-err {worst:.2e} "
              f"(worst of {len(errs)} ranks)")
        assert worst < 1e-10
    print("quickstart OK")


if __name__ == "__main__":
    main()
