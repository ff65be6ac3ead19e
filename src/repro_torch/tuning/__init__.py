"""FFT plan autotuning (paper Ch. 4 + §5.5 as a search problem) — port of
``repro.tuning``.

The paper's thesis is that *configuration* — task organization (sequential
vs. pipelined, Ch. 4), communication engine (switched all-to-all, torus
ring, the compute-overlapped rings, §4.3/§5.5) and vector mode (§4.4) —
decides end-to-end 3D-FFT time. ``FFT3DPlan`` exposes all of those knobs;
this package picks them automatically for a concrete
``(n, grid, real, components, dtype)`` problem:

1. enumerate the valid plan space        (``space.candidate_space``),
2. prune it with the paper's analytic model (``perfmodel.estimate_plan_seconds``),
3. time the survivors after a warm-up call (``timing.time_us``), scoring
   ``fwd_weight·t_fwd + inv_weight·t_inv`` (default 1:1 — a spectral
   solver runs both directions every step), the kernels of the port's
   backends and engines among them,
4. persist the winner in a JSON plan cache keyed by a canonical problem
   fingerprint including the torch and CUDA versions, the device and the
   objective weights (``cache.PlanCache``), so repeat runs are free.

The pruning of step 2 prefers *measured* model constants when a
``repro_torch.tuning.calibrate`` run has been persisted for this substrate
(``python -m repro_torch.tuning.calibrate``); the H100 priors in
``perfmodel`` remain as fallbacks.  On a grid of more than one rank every
entry point runs in each rank process, and the ranks agree on the
candidates, their times and the winner (``tuning.autotune``).

Entry points: ``autotune(...)``, ``autotune_solver_step(...)``,
``make_fft3d(..., autotune=True)``, the solver CLI's ``--autotune``,
``python -m repro_torch.tuning.cli`` and
``python -m repro_torch.tuning.calibrate``.
"""

from repro_torch.tuning.autotune import (TuneResult, autotune, time_candidate,
                                         time_candidate_pair)
from repro_torch.tuning.cache import PlanCache, default_cache_path, problem_fingerprint
from repro_torch.tuning.calibrate import (default_calibration_path,
                                          load_active_calibration, run_calibration,
                                          save_calibration, validate_calibration)
from repro_torch.tuning.solver import autotune_solver_step, time_solver_step
from repro_torch.tuning.space import DEFAULT_CANDIDATE, Candidate, candidate_space
from repro_torch.tuning.timing import time_us

__all__ = [
    "autotune", "time_candidate", "time_candidate_pair", "TuneResult",
    "autotune_solver_step", "time_solver_step",
    "Candidate", "DEFAULT_CANDIDATE", "candidate_space",
    "PlanCache", "default_cache_path", "problem_fingerprint",
    "default_calibration_path", "load_active_calibration", "run_calibration",
    "save_calibration", "validate_calibration",
    "time_us",
]
