"""The ranks of a pencil grid: one process each.

Counterpart of the JAX package's mesh plumbing (``repro.compat.axes_size``
and ``flat_axis_index``, ``repro.launch.mesh``), where ``shard_map`` runs
one program over a device mesh.  Here every rank is a process under
``torch.distributed``:

* :func:`run_ranks` spawns the ``Pu·Pv`` processes (``spawn`` start
  method), joins them into one gloo group through a ``TCPStore`` on
  localhost that the parent opens (and so holds its port) before any
  rank starts, binds rank ``r`` to ``cuda:{r % device_count}`` when the
  run is on the card, and runs ``fn(ctx, *args)`` in each.  It watches
  the processes as well as their results: a rank that dies without
  reporting (``os._exit``, a signal, a CUDA abort) stops the run within
  a second or two, and every failure raises :class:`RankFailure` with
  the ranks' exit codes;
* the mesh is 2-axis ``("data", "model")`` (``u`` over ``"data"``) or,
  with ``u_sizes=(q₀, q₁)``, 3-axis ``("pod", "data", "model")`` with
  ``u`` over ``("pod", "data")``, as the reference's 3-axis meshes are.
  Ranks are row-major over the mesh axes, like ``flat_axis_index``: rank
  ``r`` sits at grid coordinates ``(u, v) = (r // Pv, r % Pv)``, and the
  flat ``u`` of a 3-axis mesh is ``pod·|data| + data``;
* :class:`RankContext` holds this process's place: its coordinates, the
  gloo group of each grid dimension (the ranks that share its ``v``, or
  its ``u``) and of each mesh axis of a dimension that spans several, and
  the wires that carry their block exchanges: the plain gloo wire for CPU
  tensors (:class:`repro_torch.core.transpose.GlooWire`), the peer-mapped
  wire of the ring kernels for CUDA tensors
  (:class:`repro_torch.kernels.ring_rdma.IpcWire`).

Several ranks may share one card: the peer-mapped wire does not need one
card per rank, and NCCL is not used.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import queue
import time
import traceback

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from repro_torch.core.decomposition import PencilGrid
from repro_torch.device import resolve_device

_CONTEXT = None

#: seconds a rank waits in one collective before the run is called hung
TIMEOUT_S = 600
#: seconds between two looks at the rank processes while run_ranks waits
POLL_S = 0.1
#: seconds the other ranks get to exit on their own once one has failed
#: (the fleet's kill makes every rank exit with the same code) before
#: they are terminated
GRACE_S = 2.0

#: the names of the mesh axes, as the reference's meshes name them: ``u``
#: over ``("data",)`` or ``("pod", "data")``, ``v`` over ``("model",)``
U_AXES = ("pod", "data")
V_AXES = ("model",)


def coords_of(rank: int, pv: int) -> tuple[int, int]:
    """Grid coordinates ``(u, v)`` of a rank, row-major."""
    return rank // pv, rank % pv


def rank_of(u: int, v: int, pv: int) -> int:
    """The rank at grid coordinates ``(u, v)``."""
    return u * pv + v


def layout(pu: int, pv: int, u_sizes=None) -> PencilGrid:
    """The grid of a run's ranks, seen from rank 0: ``u`` over ``"data"``,
    or over ``("pod", "data")`` when ``u_sizes`` factors ``pu`` in two;
    ``v`` over ``"model"``."""
    u_sizes = tuple(int(q) for q in (u_sizes or (pu,)))
    if not 1 <= len(u_sizes) <= len(U_AXES) or math.prod(u_sizes) != pu:
        raise ValueError(f"u_sizes {u_sizes} do not factor pu={pu} over at "
                         f"most the mesh axes {U_AXES}")
    u_axes = U_AXES[-len(u_sizes):]
    return PencilGrid.from_mesh(dict(zip(u_axes + V_AXES, u_sizes + (pv,))),
                                u_axes=u_axes, v_axes=V_AXES)


def _lines(sizes, k: int) -> list[list[int]]:
    """Every line of mesh axis ``k`` (of a row-major mesh of ``sizes``):
    the ranks that differ only in coordinate ``k``, in its order."""
    stride = math.prod(sizes[k + 1:])
    return [[r + c * stride for c in range(sizes[k])]
            for r in range(math.prod(sizes)) if (r // stride) % sizes[k] == 0]


class RankContext:
    """This process's place among the ranks of a grid (``grid``: the run's
    :func:`layout`).

    Built collectively in every rank: each creates every group, in one
    order, as ``torch.distributed.new_group`` requires.  Groups are keyed
    ``(dim, label)``: the label of a grid dimension's group is its axes
    joined by ``*`` (``"data"``, ``"pod*data"``), that of one mesh axis of a
    dimension over several communicating axes the axis' name.
    """

    def __init__(self, grid: PencilGrid, rank: int, device: torch.device):
        self.pu, self.pv, self.rank = grid.pu, grid.pv, rank
        self.coords = coords_of(rank, grid.pv)
        self.layout = dataclasses.replace(grid, coords=self.coords)
        self.device = device
        sizes = grid.u_sizes + grid.v_sizes
        lines = {}  # (dim, label) -> every line of that group, in order
        for dim, flat in (("u", [[rank_of(i, j, grid.pv) for i in range(grid.pu)]
                                 for j in range(grid.pv)]),
                          ("v", [[rank_of(i, j, grid.pv) for j in range(grid.pv)]
                                 for i in range(grid.pu)])):
            if grid.dim_ranks(dim) > 1:
                lines[(dim, self._flat_label(dim))] = flat
        for dim in ("u", "v"):
            comm = grid.comm_axes(dim)
            if len(comm) > 1:
                offset = 0 if dim == "u" else len(grid.u_sizes)
                for k, axis in enumerate(grid.dim_axes(dim)):
                    if sizes[offset + k] > 1:
                        lines[(dim, axis)] = _lines(sizes, offset + k)
        self.groups, self.members = {}, {}
        for key, group_lines in lines.items():
            for ranks in group_lines:
                g = tdist.new_group(ranks, timeout=datetime.timedelta(seconds=TIMEOUT_S))
                if rank in ranks:
                    self.groups[key], self.members[key] = g, ranks
        self._wires: dict = {}

    @property
    def p(self) -> int:
        return self.pu * self.pv

    def grid(self) -> PencilGrid:
        """The pencil grid of the run, seen from this rank."""
        return self.layout

    def _flat_label(self, dim: str) -> str:
        """The label of grid dimension ``dim``'s own group and wire: its
        mesh axes joined by ``*``, as the reference labels an exchange
        over them."""
        return "*".join(self.layout.dim_axes(dim))

    def wire(self, dim: str, device, axis: str | None = None) -> object | None:
        """The wire of grid dimension ``dim`` (all its ranks), or with
        ``axis`` of that mesh axis of it, for tensors on ``device``: None
        for a dimension of one rank.  Made at first use, collectively over
        its ranks (which reach it in the same order)."""
        if self.layout.dim_ranks(dim) <= 1:
            return None
        from repro_torch.core.transpose import GlooWire
        from repro_torch.kernels import ring_rdma

        label = self._flat_label(dim) if axis is None else axis
        device = torch.device(device)
        key = (dim, label, device.type)
        if key not in self._wires:
            ranks = self.members[(dim, label)]
            me = ranks.index(self.rank)
            group = self.groups[(dim, label)]
            if ring_rdma.use_rdma(device):
                self._wires[key] = ring_rdma.IpcWire(group, ranks, me, self.device,
                                                     label=label)
            else:
                self._wires[key] = GlooWire(group, ranks, me, label=label)
        return self._wires[key]

    def axis_wires(self, dim: str, device) -> tuple | None:
        """The wires of the staged exchange over grid dimension ``dim``:
        one per communicating mesh axis, outermost first (a dimension with
        one such axis has its own wire), or None for a dimension of one
        rank."""
        comm = self.layout.comm_axes(dim)
        if not comm:
            return None
        if len(comm) == 1:
            return (self.wire(dim, device),)
        return tuple(self.wire(dim, device, axis=a) for a, _ in comm)

    def wires(self) -> dict:
        """The wires made so far, keyed by ``(dim, label, device type)``."""
        return dict(self._wires)

    def close(self) -> None:
        """Release the wires (collective: every rank calls it)."""
        for key in sorted(self._wires):
            self._wires.pop(key).close()


def context() -> RankContext | None:
    """This process's :class:`RankContext`, or None outside ``run_ranks``."""
    return _CONTEXT


def regrid(pu: int, pv: int, *, u_sizes=None) -> RankContext:
    """Re-cut the running ranks into a ``pu × pv`` grid of the same size,
    ``u`` over the mesh axes of ``u_sizes`` as in :func:`run_ranks`
    (collective: every rank calls it); the old context's wires are
    released.  Returns the new context."""
    global _CONTEXT
    ctx = context()
    if ctx is None or pu * pv != ctx.p:
        raise ValueError(f"cannot re-cut {ctx.p if ctx else 0} ranks into "
                         f"a {pu}x{pv} grid")
    grid = layout(pu, pv, u_sizes)
    ctx.close()
    _CONTEXT = RankContext(grid, ctx.rank, ctx.device)
    return _CONTEXT


def bind_grid(grid: PencilGrid, who: str) -> PencilGrid:
    """``grid`` as this process runs it.

    A 1×1 grid runs anywhere.  A larger one must be the grid of the running
    ranks (:func:`run_ranks`), its mesh axes included, and comes back with
    this rank's coordinates.
    """
    if grid.p == 1:
        return grid
    ctx = context()
    mine = None if ctx is None else ctx.grid()
    if mine is None or dataclasses.replace(grid, coords=mine.coords) != mine:
        have = "no ranks" if ctx is None else f"ranks of a {mine.mesh_label} mesh"
        raise RuntimeError(
            f"{who}: a {grid.mesh_label} mesh runs in its {grid.p} rank "
            f"processes, started by repro_torch.dist.run_ranks ({have} here)")
    return mine


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


class RankFailure(RuntimeError):
    """A run of :func:`run_ranks` failed: a rank raised, exited without a
    result, or the run outlived its timeout.  ``rank`` is the rank that
    failed first (None for a timeout); ``exit_codes`` maps every rank to
    its process's exit code once the run was stopped (negative: the
    signal that ended it, ``-15`` for the ranks stopped here)."""

    def __init__(self, msg: str, rank: int | None, exit_codes: dict):
        super().__init__(msg)
        self.rank = rank
        self.exit_codes = dict(exit_codes)


def _worker(fn, grid, rank, port, device, args, results):
    global _CONTEXT
    try:
        timeout = datetime.timedelta(seconds=TIMEOUT_S)
        store = tdist.TCPStore("localhost", port, is_master=False, timeout=timeout)
        tdist.init_process_group("gloo", store=store, rank=rank,
                                 world_size=grid.p, timeout=timeout)
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        _CONTEXT = RankContext(grid, rank, dev)
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


def _wait(procs, results, tag: str, timeout: float):
    """Collect every rank's result; returns ``(outs, None)``, or
    ``(outs, (message, rank))`` at the first failure: a rank's traceback,
    a rank process that exited without a result, or the deadline."""
    outs: list = [None] * len(procs)
    done: set = set()
    deadline = time.monotonic() + timeout
    while len(done) < len(procs):
        try:
            rank, ok, value = results.get(timeout=POLL_S)
        except queue.Empty:
            dead = [r for r, proc in enumerate(procs)
                    if r not in done and proc.exitcode is not None]
            if dead:
                try:  # a rank's last report may still be in the pipe
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    r = dead[0]
                    return outs, (f"rank {r} of {tag} exited with code "
                                  f"{procs[r].exitcode} without a result", r)
            elif time.monotonic() > deadline:
                return outs, (f"the {tag} ranks did not finish within "
                              f"{timeout} s", None)
            else:
                continue
        if not ok:
            return outs, (f"rank {rank} of {tag} failed:\n{value}", rank)
        outs[rank] = value
        done.add(rank)
    return outs, None


def run_ranks(fn, pu: int, pv: int, *, u_sizes=None, device="cuda", args=(),
              timeout: float = 3 * TIMEOUT_S) -> list:
    """Run ``fn(ctx, *args)`` in each of the ``pu·pv`` rank processes of a
    ``pu × pv`` grid; returns the per-rank results, rank-ordered.

    ``u_sizes`` factors ``pu`` over mesh axes: ``(2, 2)`` makes the 3-axis
    mesh ``("pod", "data", "model")`` of sizes ``(2, 2, pv)`` with ``u``
    over ``("pod", "data")``, whose folds over ``u`` run one exchange per
    mesh axis (the staged exchange).  ``fn`` must be importable by name
    (the processes start fresh), and its arguments and results picklable.
    ``device`` is where the ranks run: ``"cuda"`` binds rank ``r`` to card
    ``r % device_count`` (and raises here when there is none), ``"cpu"``
    keeps them on the host.  When a rank fails (raises, or its process
    exits without a result), the others are stopped and
    :class:`RankFailure` raises with the first failure and every rank's
    exit code; so does a run that outlives ``timeout`` seconds.
    """
    if pu < 1 or pv < 1:
        raise ValueError(f"a {pu}x{pv} grid has no ranks")
    grid = layout(pu, pv, u_sizes)
    dev = resolve_device(device)
    p = grid.p
    # the store listens before any rank starts, on a port the OS picks and
    # this process holds until the run ends: no other run can take it
    store = tdist.TCPStore("localhost", 0, is_master=True, wait_for_workers=False,
                           timeout=datetime.timedelta(seconds=TIMEOUT_S))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(fn, grid, r, store.port, dev.type,
                                                 tuple(args), results))
             for r in range(p)]
    # until _wait returns, a failure: anything raised here stops every rank
    outs, failure = None, ("interrupted", None)
    try:
        for proc in procs:
            proc.start()
        outs, failure = _wait(procs, results, grid.mesh_label, timeout)
    finally:
        started = [proc for proc in procs if proc.pid is not None]
        if failure is not None:  # the others get GRACE_S to exit by themselves
            end = time.monotonic() + GRACE_S
            for proc in started:
                proc.join(timeout=max(0.0, end - time.monotonic()))
        for proc in started:
            if failure is not None and proc.is_alive():
                proc.terminate()
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
                proc.join()
        del store
    if failure is not None:
        msg, rank = failure
        raise RankFailure(msg, rank, {r: proc.exitcode for r, proc in enumerate(procs)})
    return outs
