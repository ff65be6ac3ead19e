"""Meshes of rank processes for the LM launchers.

Port of ``repro.launch.mesh``.  The reference lays a ``DATAxMODEL`` mesh
(``("data", "model")``) or a multi-pod one (``("pod", "data", "model")``)
over devices; here each device is a rank process of
:func:`repro_torch.dist.run_ranks`: ``u`` over ``"data"`` (or over
``("pod", "data")``, ``u_sizes=(pod, data)``) and ``v`` over ``"model"``,
ranks row-major over the mesh axes.  :func:`mesh_of` reads the mesh of the
running ranks (:func:`repro_torch.dist.regrid` re-cuts them).  There are
no fake host devices to make: a rank is a process.
"""

from __future__ import annotations

import os

import torch

from repro_torch import dist
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh, mesh_axes, mesh_coords  # noqa: F401
from repro_torch.models.transformer import RunCfg, init_model, shard_model


def parse_mesh_arg(text: str) -> tuple[int, int]:
    """Parse a CLI ``--mesh PUxPV`` string (e.g. ``4x2``) into ``(pu, pv)``;
    raises ``SystemExit`` with a usage message on malformed input."""
    try:
        pu, pv = (int(t) for t in text.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh must look like 4x2, got {text!r}")
    if pu < 1 or pv < 1:
        raise SystemExit(f"--mesh must have positive sizes, got {text!r}")
    return pu, pv


def rank_layout(shape: dict) -> dict:
    """The :func:`repro_torch.dist.run_ranks` (or :func:`dist.regrid`)
    arguments of a mesh: ``pu``, ``pv`` and, for a pod axis, ``u_sizes``."""
    if "pod" in shape:
        return {"pu": shape["pod"] * shape["data"], "pv": shape["model"],
                "u_sizes": (shape["pod"], shape["data"])}
    return {"pu": shape["data"], "pv": shape["model"]}


def share_host(ctx) -> None:
    """On CPU ranks, give this rank its share of the host's cores as torch
    threads: P ranks each running on every core spend their time waiting
    on each other's threads."""
    if ctx.device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // ctx.p))


def _on_rank(ctx, fn, args):
    share_host(ctx)
    return fn(ctx, *args)


def run_on_mesh(fn, shape: dict, *, device="cuda", args=()) -> list:
    """``fn(ctx, *args)`` in each rank process of the mesh ``shape``
    (:func:`share_host` first); returns the per-rank results,
    rank-ordered."""
    lay = rank_layout(shape)
    return dist.run_ranks(_on_rank, lay["pu"], lay["pv"], u_sizes=lay.get("u_sizes"),
                          device=device, args=(fn, tuple(args)))


def regrid_mesh(shape: dict):
    """Re-cut the running ranks into the mesh ``shape`` (collective)."""
    lay = rank_layout(shape)
    return dist.regrid(lay["pu"], lay["pv"], u_sizes=lay.get("u_sizes"))


def mesh_of(ctx=None) -> Mesh | None:
    """The mesh of the running ranks as this rank sees it (axes in mesh
    order, this rank's coordinates), or None outside ``run_ranks``."""
    ctx = ctx or dist.context()
    if ctx is None:
        return None
    grid = ctx.grid()
    shape = dict(zip(grid.u_axes + grid.v_axes, grid.u_sizes + grid.v_sizes))
    return Mesh(shape=shape, coords=mesh_coords(ctx.rank, shape))


def rank_setup(cfg, ctx, device, *, seed: int = 0, remat: bool = True):
    """``(run, model, device)`` of a launcher's run: on one device
    (``ctx`` None; ``device`` as given, :func:`resolve_device`), or as the
    rank ``ctx`` of its mesh (its device; the model's parameters this
    rank's shards).  The parameters are ``init_model``'s from ``seed``."""
    mesh = mesh_of(ctx) if ctx is not None else None
    dev = ctx.device if ctx is not None else resolve_device(device)
    model = init_model(cfg, seed=seed, device=dev)
    if mesh is not None:
        shard_model(model, mesh)
    return RunCfg(mesh=mesh, remat=remat), model, dev
