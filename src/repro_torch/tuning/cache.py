"""Persistent JSON plan cache — port of ``repro.tuning.cache``.

Entries are keyed by a canonical *problem fingerprint* — the transform
(n, Pu×Pv grid, real/complex, μ components, dtype) plus the software/hardware
substrate (torch and CUDA versions, device type, device name and count:
:func:`substrate`) — so a cached winner is never replayed on a machine where
the measurement would not transfer.  The default file is the port's own
(``~/.cache/repro_torch/``), so a winner the JAX package tuned is never
replayed here either.

File layout (one file, many problems)::

    {"schema": "fft-plan-cache/v1",
     "entries": {"<fingerprint>": {"problem": {...}, "best": {...},
                                   "us_per_call": 123.4, "rows": [...],
                                   "created": "..."}}}

Writes are atomic (tmp file + ``os.replace``) so concurrent benchmark jobs
cannot tear the file.
"""

from __future__ import annotations

import hashlib
import json
import os

SCHEMA = "fft-plan-cache/v1"
ENV_VAR = "REPRO_TORCH_PLAN_CACHE"


def default_cache_path() -> str:
    """``$REPRO_TORCH_PLAN_CACHE`` if set, else
    ``~/.cache/repro_torch/fft_plans.json``."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "fft_plans.json")


def substrate(device=None) -> dict:
    """Identity of the substrate a measurement on ``device`` ran on: torch
    and CUDA versions, device type, device name and the count of devices of
    that type.  ``None`` is this process's substrate: the card when CUDA is
    available, else the CPU."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda or "none",
        "device_type": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "device_count": torch.cuda.device_count() if cuda else 1,
    }


def problem_fingerprint(n, pu: int, pv: int, *, real: bool = False,
                        components: int = 0, dtype: str = "float32",
                        u_axes=("data",), v_axes=("model",),
                        fwd_weight: float = 1.0,
                        inv_weight: float = 1.0,
                        case: str = "",
                        solver_params: dict | None = None,
                        device=None) -> tuple[str, dict]:
    """(key, payload): canonical id of a tuning problem on this substrate.

    The objective weights (``w_fwd·t_fwd + w_inv·t_inv``) are part of the
    fingerprint: a forward-only winner must never be replayed for a solver
    that pays for both directions. For the solver-step objective, ``case``
    (the registered solver name) and its physics ``solver_params`` join the
    fingerprint too — a plan tuned against a bare transform or a different
    workload is never replayed for another case.  ``device`` is where the
    problem runs (:func:`substrate`).
    """
    nx, ny, nz = (n, n, n) if isinstance(n, int) else tuple(n)
    payload = {
        "schema": SCHEMA,
        "n": [int(nx), int(ny), int(nz)],
        "pu": int(pu), "pv": int(pv),
        "u_axes": list(u_axes), "v_axes": list(v_axes),
        "real": bool(real), "components": int(components),
        "dtype": str(dtype),
        "fwd_weight": float(fwd_weight), "inv_weight": float(inv_weight),
        **substrate(device),
    }
    if case:
        payload["case"] = str(case)
        payload["solver_params"] = dict(solver_params or {})
    digest = hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]
    kind = ("r2c" if real else "c2c") + (f"_mu{components}" if components else "")
    prefix = f"solver_{case}_" if case else ""
    key = (f"{prefix}n{nx}x{ny}x{nz}_p{pu}x{pv}_{kind}_"
           f"{payload['dtype']}_{digest}")
    return key, payload


class PlanCache:
    def __init__(self, path: str | None = None):
        self.path = path or default_cache_path()

    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {"schema": SCHEMA, "entries": {}}
        if data.get("schema") != SCHEMA:
            return {"schema": SCHEMA, "entries": {}}
        return data

    def get(self, key: str) -> dict | None:
        from repro_torch import obs
        entry = self._load()["entries"].get(key)
        obs.metrics.inc("plan_cache.hits" if entry is not None
                        else "plan_cache.misses")
        return entry

    def put(self, key: str, entry: dict) -> None:
        data = self._load()
        data["entries"][key] = entry
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        tmp = self.path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, self.path)

    def keys(self) -> list[str]:
        return sorted(self._load()["entries"])
