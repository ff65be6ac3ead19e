"""Port parity: the four solver cases of ``repro_torch`` against the JAX
package's, on a 1×1 mesh, f64.

* per-step observables agree to ≤1e-10 relative (``observables_rel_err``;
  roundoff diagnostics are measured against the scale of what they
  measure);
* each case's ``validate()`` passes in both packages;
* a JAX state after one step, carried across with ``state_from_numpy``,
  steps to the JAX state after two, to ≤1e-10 of the fields' largest entry.

heat and nls run the reference's Pallas kernel in interpret mode
(``backend="pallas"``); poisson and navier_stokes use ``backend="ref"``,
the reference's pure-jnp radix-2 version, because its interpret mode over
a whole Navier–Stokes step takes minutes to compile on the CPU.
"""

import numpy as np
import pytest
import torch

from repro import compat
from repro.solvers import make_solver as jmake_solver
from repro_torch.core import decomposition as dec
from repro_torch.solvers import (SOLVERS, SolverState, integrators,
                                 make_solver, state_from_numpy,
                                 state_to_numpy)
from repro_torch.solvers.base import normalize_config, observables_rel_err

GRID = dec.PencilGrid.from_mesh(1, 1)
CASES = [("heat", 8, "pallas"), ("nls", 8, "pallas"),
         ("poisson", 16, "ref"), ("navier_stokes", 8, "ref")]


@pytest.fixture(scope="module")
def mesh11():
    return compat.make_mesh((1, 1), ("data", "model"))


def jax_fields(state):
    return tuple(np.asarray(a) for a in state.fields)


def fields_close(got, want, tol=1e-10):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-300)


@pytest.mark.parametrize("case,n,backend", CASES)
def test_case_matches_reference(mesh11, case, n, backend):
    cfg = {"backend": backend}
    js = jmake_solver(case, mesh11, n, plan_cfg=cfg)
    ps = make_solver(case, GRID, n, device="cpu", plan_cfg=cfg)
    assert ps.plan_config() == js.plan_config()
    assert ps.params() == js.params()

    jstate, jhist = js.run(2)
    pstate, phist = ps.run(2)
    for a, b in zip(phist, jhist):
        assert a["t"] == b["t"]
        assert observables_rel_err(a, b) <= 1e-10, (a, b)
    for s, hist in ((ps, phist), (js, jhist)):
        ok, lines = s.validate(hist)
        assert ok, lines
    fields_close(state_to_numpy(pstate), jax_fields(jstate))

    # carry the reference's state after one step across; one port step
    # must land on the reference's step 2
    j1 = js.step(js.init_state())
    j2 = js.step(j1)
    p1 = state_from_numpy(jax_fields(j1), "cpu", t=j1.t, n_steps=j1.n_steps)
    assert all(f.dtype == torch.float64 for f in p1.fields)
    p2 = ps.step(p1)
    assert (p2.n_steps, p2.t) == (j2.n_steps, pytest.approx(j2.t))
    fields_close(state_to_numpy(p2), jax_fields(j2))


@pytest.mark.parametrize("fused", [False, True])
def test_heat_fused_roundtrip_matches_reference(mesh11, fused):
    cfg = {"backend": "ref", "fused_roundtrip": fused, "chunks": 3}
    _, jhist = jmake_solver("heat", mesh11, 16, plan_cfg=cfg).run(2)
    _, phist = make_solver("heat", GRID, 16, device="cpu", plan_cfg=cfg).run(2)
    for a, b in zip(phist, jhist):
        assert observables_rel_err(a, b) <= 1e-10


def test_registry_and_contract():
    assert set(SOLVERS) == {"poisson", "heat", "navier_stokes", "nls"}
    with pytest.raises(ValueError, match="unknown solver case"):
        make_solver("burgers", GRID, 8, device="cpu")
    s = make_solver("heat", GRID, 8, device="cpu", dtype="float32")
    st = s.init_state()
    assert isinstance(st, SolverState) and (st.t, st.n_steps) == (0.0, 0)
    st2 = s.step(st)
    assert st2.n_steps == 1 and st2.t == pytest.approx(s.dt)
    assert all(f.dtype == torch.float32 for f in st2.fields)
    obs = s.observables(st2)
    assert {"amp", "mean", "energy", "t"} <= set(obs)
    assert all(isinstance(v, float) for v in obs.values())
    with pytest.raises(ValueError, match="floating"):
        make_solver("heat", GRID, 8, device="cpu", dtype="int32")


def test_normalize_config_maps_net():
    from repro.tuning.space import normalize_config as jnormalize
    for cfg in ({"net": "torus"}, {"net": "torus", "comm_engine": "bidi_ring"},
                {"backend": "ref"}):
        assert normalize_config(cfg) == jnormalize(cfg)
    s = make_solver("poisson", GRID, 8, device="cpu", plan_cfg={"net": "torus"})
    assert s.plan.comm_engine == "torus"


def test_integrators_match_reference():
    import jax.numpy as jnp
    from repro.solvers import integrators as jint

    rng = np.random.default_rng(4)
    y = (rng.standard_normal((3, 4)), rng.standard_normal((3, 4)))
    decay = -np.abs(rng.standard_normal((3, 4)))

    def nonlin(t):
        return tuple(0.1 * a * a - 0.3 * a for a in t)

    yt = tuple(torch.from_numpy(a) for a in y)
    yj = tuple(jnp.asarray(a) for a in y)
    for got, want in (
            (integrators.rk4(nonlin, yt, 0.1), jint.rk4(nonlin, yj, 0.1)),
            (integrators.exp_decay(torch.from_numpy(decay), yt, 0.1),
             jint.exp_decay(jnp.asarray(decay), yj, 0.1)),
            (integrators.ifrk4(nonlin, torch.from_numpy(decay), yt, 0.1),
             jint.ifrk4(nonlin, jnp.asarray(decay), yj, 0.1))):
        fields_close([g.numpy() for g in got], [np.asarray(w) for w in want],
                     tol=1e-14)


def test_observables_rel_err_floors_roundoff_diagnostics():
    a = {"energy": 1.0, "max_div": 3e-9, "t": 0.0}
    b = {"energy": 1.0 + 1e-12, "max_div": 1e-9, "t": 0.0}
    # max_div is roundoff: measured against its floor of 100, not itself
    assert observables_rel_err(a, b) == pytest.approx(2e-11)
    assert observables_rel_err({"energy": 1.0}, {"energy": 1.1}) > 0.09
