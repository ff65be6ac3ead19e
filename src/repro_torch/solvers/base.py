"""The ``SpectralSolver`` contract — port of ``repro.solvers.base``.

One workload of the paper's simulation cycle (§1.2):

    forward 3D FFT → spectral computation → inverse 3D FFT → local computation

* ``init_state()``        — the t=0 :class:`SolverState`;
* ``step(state)``         — advance one Δt, eagerly on the solver's device;
* ``observables(state)``  — scalar diagnostics as ``{name: float}``;
* ``batched_step(fields)`` / ``batched_observables(fields)`` — the same
  over a leading lane axis of B stacked simulations (the serving layer's
  entry point), each lane bitwise its solo run.

Concrete solvers implement ``initial_fields`` / ``step_fields`` /
``observables_fields`` and ``validate``; the base class owns plan
construction, the device, and the run loop.  The FFT plan knobs come from
``plan_cfg``, over the same pipelined/switched default as the reference.

On a grid of more than one rank every rank process of
:func:`repro_torch.dist.run_ranks` builds the solver; each holds its block
of the fields (the global fields, computed from the same 1D factors on
every rank, cut by its grid coordinates) and the observables reduce over
the ranks.

``state_tree``/``restore_state`` are the checkpoint contract
(:class:`repro_torch.checkpoint.CheckpointManager`): the fields are saved
as full logical arrays, so a checkpoint restores onto any grid of the same
problem, and onto the reference's solvers.  ``step`` and ``observables``
are the ``dispatch/solver.step`` and ``dispatch/solver.observables`` spans
when obs is enabled (``step`` then waits for the card, and carries the
perf model's ``model_predicted_us``, :meth:`SpectralSolver.predict_step_us`);
disabled, they cost one branch.  :meth:`SpectralSolver.problem_key` is the
plan cache's fingerprint of the problem (``repro_torch.tuning``).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import ClassVar

import numpy as np
import torch

from repro_torch import dist, obs
from repro_torch.core import perfmodel as pm
from repro_torch.core import precision
from repro_torch.core.decomposition import PencilGrid
from repro_torch.core.fft3d import FFT3DPlan, gather_pencil, scatter_pencil
from repro_torch.device import resolve_device
from repro_torch.tuning.space import normalize_config


@dataclasses.dataclass
class SolverState:
    """Evolving solver state: a tuple of field tensors + the host clock."""

    fields: tuple
    t: float = 0.0
    n_steps: int = 0


def state_from_numpy(fields, device, *, t: float = 0.0,
                     n_steps: int = 0) -> SolverState:
    """A :class:`SolverState` on ``device`` from a tuple of arrays (e.g. a
    reference solver's fields, converted with ``np.asarray``)."""
    dev = resolve_device(device)
    return SolverState(
        fields=tuple(torch.from_numpy(np.array(a)).to(dev) for a in fields),
        t=float(t), n_steps=int(n_steps))


def state_to_numpy(state: SolverState) -> tuple:
    """The state's fields as a tuple of numpy arrays."""
    return tuple(a.detach().cpu().numpy() for a in state.fields)


#: Observables that measure roundoff (an error norm, a mean that is zero
#: analytically, a divergence): two runs agree on them only to the scale of
#: what they measure, so ``observables_rel_err`` divides by at least this.
OBSERVABLE_SCALES = {"err_inf": 1.0, "err_l2": 1.0, "mean": 1.0,
                     "max_div": 100.0}


def observables_rel_err(a: dict, b: dict) -> float:
    """Largest relative difference of two observable dicts,
    ``|a−b| / max(|a|, |b|, scale)`` with the floors of
    ``OBSERVABLE_SCALES`` (0 for every other observable)."""
    worst = 0.0
    for k in a:
        if k == "t":
            continue
        den = max(abs(a[k]), abs(b[k]), OBSERVABLE_SCALES.get(k, 0.0))
        if den > 0:
            worst = max(worst, abs(a[k] - b[k]) / den)
    return worst


class SpectralSolver(abc.ABC):
    """Common contract every FFT-cycle simulation workload implements."""

    case: ClassVar[str]            # registry name (``--case`` on the CLI)
    real: ClassVar[bool] = True    # r2c transform (False: planar complex)
    components: ClassVar[int] = 0  # leading vector axis (0 = scalar field)

    def __init__(self, grid: PencilGrid, n, *, dt: float = 1e-2,
                 dtype="float64", plan_cfg: dict | None = None,
                 device="cuda"):
        grid = dist.bind_grid(grid, f"solvers.{self.case}")
        self.device = resolve_device(device)
        self.n = (n, n, n) if isinstance(n, int) else tuple(n)
        self.dt = float(dt)
        self.dtype = precision.require_dtype(dtype, who=f"solvers.{self.case}")
        self.torch_dtype = precision.torch_dtype(self.dtype)
        cfg = dict(schedule="pipelined", chunks=2, backend="jnp",
                   comm_engine="switched", r2c_packed=False,
                   fused_roundtrip=False)
        self.vector_mode = "streaming"
        if plan_cfg:
            plan_cfg = normalize_config(plan_cfg)
            cfg.update({k: plan_cfg[k] for k in cfg if k in plan_cfg})
            self.vector_mode = plan_cfg.get("vector_mode", self.vector_mode)
        self.plan = FFT3DPlan(n=self.n, grid=grid, real=self.real,
                              dtype=self.dtype.name, **cfg)

    # ---- solver-specific hooks ------------------------------------------
    @abc.abstractmethod
    def initial_fields(self) -> tuple:
        """The t=0 field tuple, on the solver's device."""

    @abc.abstractmethod
    def step_fields(self, plan: FFT3DPlan, fields) -> tuple:
        """One Δt of the FFT→spectral→iFFT→local cycle."""

    @abc.abstractmethod
    def observables_fields(self, plan: FFT3DPlan, fields) -> dict:
        """Scalar diagnostics as 0-d tensors."""

    def spectral_kernel(self, plan: FFT3DPlan, dtype, device):
        """The k-space stage as a ``DiagonalKernel`` (on ``device``) when
        it is a pointwise-diagonal multiply, else ``None``."""
        del plan, dtype, device
        return None

    @abc.abstractmethod
    def validate(self, history: list[dict]) -> tuple[bool, list[str]]:
        """(ok, report lines) judging a run against the analytic reference;
        ``history[i]`` is ``observables`` after i steps, with ``"t"``."""

    def params(self) -> dict:
        """Physics parameters identifying this problem."""
        return {"dt": self.dt}

    # ---- helpers for the cases -------------------------------------------
    def _axes_1d(self):
        """The 1D grids ``(x, y, z)`` of the 2π³ torus, float64 numpy."""
        nx, ny, nz = self.n
        return tuple(np.linspace(0, 2 * np.pi, m, endpoint=False)
                     for m in (nx, ny, nz))

    def _on_device(self, a, axis: str = "x") -> torch.Tensor:
        """A float64 numpy factor along grid ``axis`` (``"x"``, ``"y"`` or
        ``"z"``, as :meth:`_axes_1d`) as a float64 tensor on the device,
        cut to this rank's block: the X-pencil splits y over ``u`` and z
        over ``v``."""
        g = self.plan.grid
        cut = {"x": (0, 1), "y": (g.coords[0], g.pu), "z": (g.coords[1], g.pv)}
        i, parts = cut[axis]
        size = len(a) // parts
        a = np.ascontiguousarray(a[i * size:(i + 1) * size])
        return torch.from_numpy(a).to(self.device)

    # ---- public contract -------------------------------------------------
    def init_state(self, plan: FFT3DPlan | None = None) -> SolverState:
        if plan is not None and plan != self.plan:
            raise ValueError("a solver steps the plan it was built for")
        return SolverState(fields=self.initial_fields(), t=0.0, n_steps=0)

    def predict_step_us(self) -> float:
        """The perf model's time for one ``step()`` of this solver's plan
        (µs). Diagonal-kernel solvers price the full spectral roundtrip of
        their plan (fused when the plan streams it); others price the same
        roundtrip composed.  The compute term is the paper's nominal FPGA
        model, the wire and messages the substrate's (``perfmodel``, under
        the calibration active at the call), so the number is tracked by
        its error against the measured step."""
        g = self.plan.grid
        diagonal = type(self).spectral_kernel is not SpectralSolver.spectral_kernel
        est = pm.estimate_roundtrip_seconds(
            self.n, g.pu, g.pv, spec=self.plan.spec(),
            fused=self.plan.fused_roundtrip and diagonal,
            mu=max(self.components, 1), pu_axes=g.u_sizes, pv_axes=g.v_sizes)
        return round(est * 1e6, 3)

    def problem_key(self) -> str:
        """This solver's plan-cache fingerprint key — the canonical id of
        (case, shape, dtype, physics params, substrate) that
        ``repro_torch.tuning`` keys tuned plans by."""
        from repro_torch.tuning.cache import problem_fingerprint

        g = self.plan.grid
        key, _ = problem_fingerprint(
            self.n, g.pu, g.pv, real=self.real, components=self.components,
            dtype=self.dtype.name, u_axes=g.u_axes, v_axes=g.v_axes,
            case=self.case, solver_params=self.params(), device=self.device)
        return key

    def step(self, state: SolverState) -> SolverState:
        if not obs.is_enabled():
            return SolverState(fields=tuple(self.step_fields(self.plan, state.fields)),
                               t=state.t + self.dt, n_steps=state.n_steps + 1)
        with obs.span("dispatch/solver.step", case=self.case,
                      engine=self.plan.comm_engine,
                      model_predicted_us=self.predict_step_us()):
            fields = tuple(self.step_fields(self.plan, state.fields))
            obs.synchronize(fields)
        return SolverState(fields=fields, t=state.t + self.dt,
                           n_steps=state.n_steps + 1)

    def observables(self, state: SolverState) -> dict:
        with obs.span("dispatch/solver.observables"):
            out = {k: float(v) for k, v in
                   self.observables_fields(self.plan, state.fields).items()}
        out["t"] = state.t
        return out

    def run(self, steps: int, *, callback=None):
        """Advance ``steps`` Δt from t=0; returns (state, observable history)."""
        state = self.init_state()
        history = [self.observables(state)]
        if callback:
            callback(state, history[-1])
        for _ in range(steps):
            state = self.step(state)
            history.append(self.observables(state))
            if callback:
                callback(state, history[-1])
        return state, history

    # ---- batched stepping (the serving layer's entry point) --------------
    def batched_step_fns(self):
        """``(step, observables)`` over a leading lane axis.

        ``step`` maps a field tuple whose tensors carry an extra leading
        axis of size B (B independent simulations of *this* problem,
        stacked) through one solver step.  The reference ``vmap``s the
        per-instance body inside its ``shard_map``; here the case's
        ``step_fields`` runs once on the whole stack (its transforms take
        leading axes), so every 1-D FFT kernel, copy and exchange of the
        step covers all B lanes in one launch.  The kernels transform each
        row on its own, so a lane's trajectory is bitwise what the solo
        ``step()`` computes.  ``observables`` gives ``{name: [B floats]}``
        (without ``"t"``, which the caller's clock holds): the solo
        reductions on each lane's own view, lane by lane (on a grid each
        lane's scalars are all-reduced one at a time, as the solo step
        does), so no lane's sum is reordered.
        """
        def step(fields) -> tuple:
            self._check_lanes(fields)
            return tuple(self.step_fields(self.plan, tuple(fields)))

        def observables(fields) -> dict:
            out: dict = {}
            for b in range(self._check_lanes(fields)):
                lane = tuple(f[b] for f in fields)
                for k, v in self.observables_fields(self.plan, lane).items():
                    out.setdefault(k, []).append(float(v))
            return out

        return step, observables

    def _check_lanes(self, fields) -> int:
        """The lane count B of a stack of this problem's fields."""
        ndim = 4 if self.components else 3
        lanes = {f.shape[0] for f in fields if f.dim() == ndim + 1}
        if len(lanes) != 1 or any(f.dim() != ndim + 1 for f in fields):
            raise ValueError(
                f"{self.case}: a batched step takes fields of {ndim + 1} "
                "dimensions with one leading lane axis, got shapes "
                f"{[tuple(f.shape) for f in fields]}")
        return lanes.pop()

    def batched_step(self, fields) -> tuple:
        """One Δt for a leading-lane-axis stack of field tuples."""
        return self.batched_step_fns()[0](fields)

    def batched_observables(self, fields) -> dict:
        """``{name: [B floats]}`` diagnostics of a batched stack."""
        return self.batched_step_fns()[1](fields)

    # ---- checkpoint contract ----------------------------------------------
    def state_tree(self, state: SolverState):
        """``state`` as a checkpointable tree for ``CheckpointManager``: the
        fields as full logical arrays plus the clock as 0-d numpy scalars,
        under the reference's paths (``fields/<i>``, ``t``, ``n_steps``).

        Collective on a grid of several ranks: each field is gathered to
        rank 0 (:func:`~repro_torch.core.fft3d.gather_pencil`), which
        alone gets the tree; the other ranks get None and write nothing.
        On one rank the fields are the state's own tensors (the manager's
        save copies them)."""
        g = self.plan.grid
        fields = (state.fields if g.p == 1
                  else tuple(gather_pencil(f, g) for f in state.fields))
        if fields and fields[0] is None:
            return None
        return {"fields": fields, "t": np.float64(state.t),
                "n_steps": np.int64(state.n_steps)}

    def restore_state(self, manager, step: int | None = None
                      ) -> tuple[SolverState, dict]:
        """``(state, manifest meta)`` from ``manager``'s checkpoint, which a
        solver of the same problem may have written on another grid (or in
        the reference package).  Every rank reads the file and cuts its own
        block (:func:`~repro_torch.core.fft3d.scatter_pencil`), so the save
        must have landed (rank 0's ``wait()``, then a barrier) before any
        rank restores.  Onto the same grid the restore is bitwise; onto
        another only the layout changes, and the trajectory continues to
        roundoff."""
        g = self.plan.grid
        fields = self.initial_fields()         # shape/dtype template

        def full(f):
            shape = f.shape[:-3] + (f.shape[-3] * g.pu, f.shape[-2] * g.pv, f.shape[-1])
            return torch.empty(shape, dtype=f.dtype, device="meta")

        def cut(a):
            return scatter_pencil(torch.from_numpy(a), g).contiguous().to(self.device)

        target = {"fields": tuple(full(f) for f in fields), "t": np.float64(0.0),
                  "n_steps": np.int64(0)}
        del fields
        tree, meta = manager.restore(target, step=step,
                                     place={"fields": tuple(cut for _ in target["fields"])})
        return SolverState(fields=tree["fields"], t=float(tree["t"]),
                           n_steps=int(tree["n_steps"])), meta

    def plan_config(self) -> dict:
        """The FFT-plan knobs this solver runs (bench metadata)."""
        p = self.plan
        return {"backend": p.backend, "schedule": p.schedule,
                "chunks": p.chunks, "comm_engine": p.comm_engine,
                "net": p.net, "vector_mode": self.vector_mode,
                "r2c_packed": p.r2c_packed,
                "fused_roundtrip": p.fused_roundtrip, "dtype": p.dtype}
