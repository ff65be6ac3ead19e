"""The ranks of a ``Pu × Pv`` pencil grid: one process each.

Counterpart of the JAX package's mesh plumbing (``repro.compat.axes_size``
and ``flat_axis_index``, ``repro.launch.mesh``), where ``shard_map`` runs
one program over a device mesh.  Here every rank is a process under
``torch.distributed``:

* :func:`run_ranks` spawns the ``Pu·Pv`` processes (``spawn`` start
  method), joins them into one gloo group over ``tcp://localhost`` on a
  free port, binds rank ``r`` to ``cuda:{r % device_count}`` when the run
  is on the card, and runs ``fn(ctx, *args)`` in each;
* rank ``r`` sits at grid coordinates ``(u, v) = (r // Pv, r % Pv)``,
  row-major like ``flat_axis_index`` over ``("data", "model")``;
* :class:`RankContext` holds this process's place: its coordinates, the
  gloo group of each grid dimension (the ranks that share its ``v``, or
  its ``u``) and, per dimension and device type, the wire that carries that
  dimension's block exchanges: the plain gloo wire for CPU tensors
  (:class:`repro_torch.core.transpose.GlooWire`), the peer-mapped wire of
  the ring kernels for CUDA tensors
  (:class:`repro_torch.kernels.ring_rdma.IpcWire`).

Several ranks may share one card: the peer-mapped wire does not need one
card per rank, and NCCL is not used.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import socket
import traceback

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from repro_torch.core.decomposition import PencilGrid
from repro_torch.device import resolve_device

_CONTEXT = None

#: seconds a rank waits in one collective before the run is called hung
TIMEOUT_S = 600


def coords_of(rank: int, pv: int) -> tuple[int, int]:
    """Grid coordinates ``(u, v)`` of a rank, row-major."""
    return rank // pv, rank % pv


def rank_of(u: int, v: int, pv: int) -> int:
    """The rank at grid coordinates ``(u, v)``."""
    return u * pv + v


class RankContext:
    """This process's place among the ranks of a ``pu × pv`` grid.

    Built collectively in every rank (each creates every dimension group,
    in one order, as ``torch.distributed.new_group`` requires).
    """

    def __init__(self, pu: int, pv: int, rank: int, device: torch.device):
        self.pu, self.pv, self.rank = pu, pv, rank
        self.coords = coords_of(rank, pv)
        self.device = device
        u, v = self.coords
        # ranks of each grid dimension, in dimension order (index = u or v)
        self.members = {"u": [rank_of(i, v, pv) for i in range(pu)],
                        "v": [rank_of(u, j, pv) for j in range(pv)]}
        self.groups = {}
        for dim, count, lines in (("u", pu, [[rank_of(i, j, pv) for i in range(pu)]
                                             for j in range(pv)]),
                                  ("v", pv, [[rank_of(i, j, pv) for j in range(pv)]
                                             for i in range(pu)])):
            if count <= 1:
                continue
            for ranks in lines:
                g = tdist.new_group(ranks, timeout=datetime.timedelta(seconds=TIMEOUT_S))
                if rank in ranks:
                    self.groups[dim] = g
        self._wires: dict = {}

    @property
    def p(self) -> int:
        return self.pu * self.pv

    def grid(self) -> PencilGrid:
        """The pencil grid of the run, seen from this rank."""
        return PencilGrid.from_mesh(self.pu, self.pv, coords=self.coords)

    def wire(self, dim: str, device) -> object | None:
        """The wire of grid dimension ``dim`` for tensors on ``device``:
        None for a dimension of one rank.  Made at first use, collectively
        over the dimension's ranks (which reach it in the same order)."""
        ranks = self.members[dim]
        if len(ranks) <= 1:
            return None
        from repro_torch.core.transpose import GlooWire
        from repro_torch.kernels import ring_rdma

        device = torch.device(device)
        key = (dim, device.type)
        if key not in self._wires:
            me = ranks.index(self.rank)
            if ring_rdma.use_rdma(device):
                self._wires[key] = ring_rdma.IpcWire(self.groups[dim], ranks, me,
                                                     self.device)
            else:
                self._wires[key] = GlooWire(self.groups[dim], ranks, me)
        return self._wires[key]

    def wires(self) -> dict:
        """The wires made so far, keyed by ``(dim, device type)``."""
        return dict(self._wires)

    def close(self) -> None:
        """Release the wires (collective: every rank calls it)."""
        for key in sorted(self._wires):
            self._wires.pop(key).close()


def context() -> RankContext | None:
    """This process's :class:`RankContext`, or None outside ``run_ranks``."""
    return _CONTEXT


def regrid(pu: int, pv: int) -> RankContext:
    """Re-cut the running ranks into a ``pu × pv`` grid of the same size
    (collective: every rank calls it); the old context's wires are
    released.  Returns the new context."""
    global _CONTEXT
    ctx = context()
    if ctx is None or pu * pv != ctx.p:
        raise ValueError(f"cannot re-cut {ctx.p if ctx else 0} ranks into "
                         f"a {pu}x{pv} grid")
    ctx.close()
    _CONTEXT = RankContext(pu, pv, ctx.rank, ctx.device)
    return _CONTEXT


def bind_grid(grid: PencilGrid, who: str) -> PencilGrid:
    """``grid`` as this process runs it.

    A 1×1 grid runs anywhere.  A larger one must be the grid of the running
    ranks (:func:`run_ranks`), and comes back with this rank's coordinates.
    A grid dimension over several mesh axes (a 3-axis mesh, staged
    per-axis exchanges) is not ported yet.
    """
    for dim in ("u", "v"):
        if sum(q > 1 for q in grid.dim_sizes(dim)) > 1:
            raise NotImplementedError(
                f"{who}: grid dimension {dim!r} spans the mesh axes "
                f"{grid.dim_sizes(dim)}; 3-axis meshes and their staged "
                "per-axis exchanges are ROADMAP Queue 1 item 5 (left out)")
    if grid.p == 1:
        return grid
    ctx = context()
    if ctx is None or (ctx.pu, ctx.pv) != (grid.pu, grid.pv):
        have = "no ranks" if ctx is None else f"ranks of a {ctx.pu}x{ctx.pv} grid"
        raise RuntimeError(
            f"{who}: a {grid.pu}x{grid.pv} grid runs in its {grid.p} rank "
            f"processes, started by repro_torch.dist.run_ranks ({have} here)")
    return dataclasses.replace(grid, coords=ctx.coords)


def all_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """Sum (``op="sum"``) or max (``"max"``) of a scalar tensor over every
    rank, through the gloo group on the host: these are a few observable
    scalars per step, not pencil data."""
    if context() is None:
        raise RuntimeError("a reduction over the grid's ranks runs inside "
                           "repro_torch.dist.run_ranks")
    ops = {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX}
    t = x.detach().to("cpu", copy=True)
    tdist.all_reduce(t, op=ops[op])
    return t.to(x.device)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(fn, pu, pv, rank, port, device, args, results):
    global _CONTEXT
    try:
        tdist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=pu * pv, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        _CONTEXT = RankContext(pu, pv, rank, dev)
        out = fn(_CONTEXT, *args)
        _CONTEXT.close()  # the context fn ended with (see regrid)
        tdist.barrier()
        tdist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which stops the others
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)


def run_ranks(fn, pu: int, pv: int, *, device="cuda", args=(),
              timeout: float = 3 * TIMEOUT_S) -> list:
    """Run ``fn(ctx, *args)`` in each of the ``pu·pv`` rank processes of a
    ``pu × pv`` grid; returns the per-rank results, rank-ordered.

    ``fn`` must be importable by name (the processes start fresh), and its
    arguments and results picklable.  ``device`` is where the ranks run:
    ``"cuda"`` binds rank ``r`` to card ``r % device_count`` (and raises
    here when there is none), ``"cpu"`` keeps them on the host.  When a
    rank fails, the others are stopped and the first traceback raises.
    """
    if pu < 1 or pv < 1:
        raise ValueError(f"a {pu}x{pv} grid has no ranks")
    dev = resolve_device(device)
    p = pu * pv
    port = _free_port()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(fn, pu, pv, r, port, dev.type,
                                                 tuple(args), results))
             for r in range(p)]
    for proc in procs:
        proc.start()
    outs: list = [None] * p
    failure = None
    try:
        for _ in range(p):
            rank, ok, value = results.get(timeout=timeout)
            if not ok:
                failure = f"rank {rank} of {pu}x{pv} failed:\n{value}"
                break
            outs[rank] = value
    except queue.Empty:
        failure = f"the {pu}x{pv} ranks did not finish within {timeout} s"
    finally:
        for proc in procs:
            if failure is not None and proc.is_alive():
                proc.terminate()
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
                proc.join()
    if failure is not None:
        raise RuntimeError(failure)
    return outs
