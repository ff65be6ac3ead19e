"""Persistent solver-engine registry: admission never rebuilds a hot shape.

Port of ``repro.serving.registry``.  The registry maps a request
fingerprint (:func:`repro_torch.serving.request.request_key`) to a live
:class:`~repro_torch.solvers.base.SpectralSolver` on one grid and device.
The first admission of a fingerprint builds the solver and, when the
request pins no explicit ``plan_cfg``, consults the persistent plan cache
(:class:`repro_torch.tuning.cache.PlanCache`) under the solver's own
``problem_key()``, so a previously autotuned plan is picked up without any
timing sweep at admission time.  Every later admission of the same
fingerprint returns the same instance, with its plan, engine and wires
already made.

On a grid of several ranks every rank process keeps its own registry;
they admit the same batches in the same order, so they hold the same
engines, and each reads the plan cache file itself (rank 0's tuner wrote
it).

Counters: ``serving.engine_cache.hits`` / ``serving.engine_cache.misses``
(per admission lookup); the plan-cache consult shows up on the existing
``plan_cache.hits`` / ``plan_cache.misses``.
"""

from __future__ import annotations

import threading

from repro_torch import obs
from repro_torch.serving.request import SimRequest, request_key


class EngineRegistry:
    """Solver engines for one grid and device, keyed by fingerprint."""

    def __init__(self, grid, *, device="cuda", use_plan_cache: bool = True,
                 cache_path: str | None = None):
        self.grid = grid
        self.device = device
        self.use_plan_cache = use_plan_cache
        self.cache_path = cache_path
        self._engines: dict[str, object] = {}
        self._lock = threading.Lock()

    def get(self, req: SimRequest, fingerprint: str | None = None):
        """The (possibly shared) solver serving ``req``'s shape."""
        key = fingerprint or request_key(req)
        with self._lock:
            solver = self._engines.get(key)
        if solver is not None:
            obs.metrics.inc("serving.engine_cache.hits")
            return solver
        obs.metrics.inc("serving.engine_cache.misses")
        solver = self._build(req)
        with self._lock:
            # a racing admission may have built it first: keep the winner
            solver = self._engines.setdefault(key, solver)
        return solver

    def _make(self, req: SimRequest, plan_cfg):
        from repro_torch.solvers import make_solver

        return make_solver(req.case, self.grid, req.n, device=self.device,
                           dtype=req.dtype, plan_cfg=plan_cfg,
                           **dict(req.params))

    def _build(self, req: SimRequest):
        plan_cfg = dict(req.plan_cfg) if req.plan_cfg is not None else None
        solver = self._make(req, plan_cfg)
        if plan_cfg is None and self.use_plan_cache:
            # reuse a step-autotuned plan when one is cached for exactly
            # this problem and substrate; building the probe solver with the
            # default plan makes no engine and no wire
            from repro_torch.tuning.cache import PlanCache

            entry = PlanCache(self.cache_path).get(solver.problem_key())
            if entry is not None and entry.get("best"):
                solver = self._make(req, dict(entry["best"]))
        return solver

    def engines(self) -> dict[str, object]:
        """Snapshot of the live fingerprint → solver map."""
        with self._lock:
            return dict(self._engines)

    def __len__(self) -> int:
        with self._lock:
            return len(self._engines)
