"""The port's Mixture of Experts on one device against the JAX package, on
the CPU (f32).

``repro_torch.models.moe`` against ``repro.models.moe``, the JAX params
carried across as numpy arrays:

* ``apply_moe`` (computed by index) and its gradients, at capacity factor
  1.25 with dropped pairs (asserted present), at 8.0, with a shared expert
  and ``router_norm_topk=False``, and with router logits tied on purpose
  (``jax.lax.top_k`` takes the lower index first among equals; so must
  the port, or arrival order and drops move); within 1e-5 of the output's
  and each gradient's max;
* the index dispatch equals the one-hot plain version (``apply_moe_plain``)
  in f32 (1e-5) and bf16 (2e-2 of the max: the two sum the same bf16
  products in another order);
* ``top_k`` on heavily tied values, bitwise ``jax.lax.top_k``'s indices;
* ``load_balance_loss`` (1e-6);
* qwen3-moe's SMOKE config through the whole model: init names and
  shapes, the forward, prefill and greedy decode (logits 2e-5, the same
  tokens), ``lm_loss`` (1e-5 relative) and its gradients (1e-4 of each
  leaf's max); the port's ``launch/serve.py`` and ``launch/train.py`` run
  it;
* the routing record and replay that phase 14 of ``chip_smoke.py`` pins
  its bf16 comparisons with: a run replayed onto itself is bitwise the
  same; a replay overrides a router's own choices and counts the flips;
* each package resumes the other's MoE trainer checkpoint (the JAX
  trainer in child processes): the next loss within 1e-4 of the writer's
  uninterrupted run.
"""

import contextlib
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config
from repro.models import moe as JM
from repro.models.common import Initializer as JaxInit
from repro.models.transformer import RunCfg as JaxRun
from repro.models.transformer import decode_step as jax_decode
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_model as jax_init
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.models.transformer import prefill as jax_prefill
from repro_torch.configs import get_config
from repro_torch.launch import serve, train
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, port_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-moe-30b-a3b"
JRUN = JaxRun(mesh=None, remat=False)
TOL = 1e-5

# (case, MoEDims fields): E=8, k=2 over 64 tokens; capacity 20 at 1.25
CASES = {
    "drops": dict(capacity_factor=1.25),
    "no_drops": dict(capacity_factor=8.0),
    "shared": dict(capacity_factor=1.25, n_shared=1, d_ff_shared=24,
                   router_norm_topk=False),
    "tied": dict(capacity_factor=1.25),
}
DIMS = dict(d_model=32, n_experts=8, top_k=2, d_ff_expert=16)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _moe_case(case, seed=0):
    fields = dict(DIMS, **CASES[case])
    jm = JM.MoEDims(**fields)
    jp = JM.init_moe(JaxInit(key=jax.random.PRNGKey(seed), dtype=jnp.float32), jm)
    if case == "tied":
        # experts 1 and 5 get the router columns of 0 and 4: their logits
        # tie with those experts' for every token
        r = np.asarray(jp["router"]).copy()
        r[:, 1], r[:, 5] = r[:, 0], r[:, 4]
        jp = dict(jp, router=jnp.asarray(r))
    # a shift common to every token skews the routing: some experts overflow
    x = (np.random.RandomState(seed + 1).randn(4, 16, DIMS["d_model"]) + 0.5).astype(np.float32)
    return jm, M.MoEDims(**fields), jp, x


@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_jax(case):
    jm, m, jp, x = _moe_case(case)
    p = _to_torch(jp)
    want = JM.apply_moe(jp, jm, jnp.asarray(x))
    got, share = M.count_drops(lambda: M.apply_moe(p, m, torch.from_numpy(x)))
    assert _rel(got.numpy(), want) <= TOL
    if case == "no_drops":
        assert share == 0
    else:
        assert share > 0, "the case must drop pairs"
    if case == "tied":
        _, top_e = M.route(torch.from_numpy(x).reshape(-1, DIMS["d_model"]), p["router"], m)
        ties = ((top_e == 0) | (top_e == 1) | (top_e == 4) | (top_e == 5)).any(-1)
        assert bool(ties.any())
    # the gradients of a weighted sum of the output, params and input
    r = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    jg, jx = jax.grad(lambda pp, xx: jnp.sum(JM.apply_moe(pp, jm, xx) * r),
                      argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {n: t.requires_grad_() for n, t in port_leaves(p).items()}
    xt = torch.from_numpy(x).requires_grad_()
    tree = {"router": leaves["router"],
            "experts": {k: leaves[f"experts.{k}"] for k in ("wi_gate", "wi_up", "wo")}}
    if "shared" in p:
        tree["shared"] = {k: leaves[f"shared.{k}"] for k in p["shared"]}
    (M.apply_moe(tree, m, xt) * torch.from_numpy(r)).sum().backward()
    assert _rel(xt.grad.numpy(), jx) <= TOL
    for name, g in port_leaves(jax.tree.map(np.asarray, jg)).items():
        assert _rel(leaves[name].grad.numpy(), g) <= TOL, name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_index_dispatch_equals_the_one_hot_plain_version(dtype, tol):
    for case in ("drops", "shared", "tied"):
        _, m, jp, x = _moe_case(case, seed=3)
        p = {k: (v.to(dtype) if torch.is_tensor(v) else {n: t.to(dtype) for n, t in v.items()})
             for k, v in _to_torch(jp).items()}
        xt = torch.from_numpy(x).to(dtype)
        got, want = M.apply_moe(p, m, xt), M.apply_moe_plain(p, m, xt)
        assert got.dtype == want.dtype == dtype
        assert _rel(got.float().numpy(), want.float().numpy()) <= tol, case


def test_top_k_takes_the_lower_index_first_among_equals():
    rng = np.random.RandomState(4)
    probs = np.round(rng.rand(64, 16) * 4) / 4          # five levels: ties galore
    probs = probs.astype(np.float32)
    for k in (1, 2, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        v, i = M.top_k(torch.from_numpy(probs), k)
        assert np.array_equal(i.numpy(), np.asarray(ji))
        assert np.array_equal(v.numpy(), np.asarray(jv))


def test_arrival_is_the_references_one_hot_cumsum():
    e = torch.from_numpy(np.random.RandomState(5).randint(0, 8, 200))
    onehot = torch.nn.functional.one_hot(e, 8)
    want = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    assert torch.equal(M.arrival(e, 8), want)
    # the two capacity rules of the reference
    m = M.MoEDims(**DIMS)
    assert M._capacity(m, 64) == 20 and M._capacity(m, 4) == 8
    assert M.ep_capacity(m, 64) == 20 and M.ep_capacity(m, 3) == 4
    assert M.ep_capacity(M.MoEDims(**dict(DIMS, capacity_factor=1.3)), 64) == 24


def test_load_balance_loss_matches_jax():
    rng = np.random.RandomState(6)
    logits = rng.randn(40, 8).astype(np.float32)
    top_e = rng.randint(0, 8, (40, 2)).astype(np.int32)
    want = JM.load_balance_loss(jnp.asarray(logits), jnp.asarray(top_e), 8)
    got = M.load_balance_loss(torch.from_numpy(logits), torch.from_numpy(top_e).long(), 8)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


# --------------------------------------------------------------------------
# qwen3-moe's SMOKE config through the whole model
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jp = jax_init(jcfg, jax.random.PRNGKey(0))[0]
    model = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (2, 16)).astype(np.int32)
    return jcfg, cfg, jp, model, toks


def test_smoke_init_names_and_shapes_match_jax(smoke):
    jcfg, cfg, _, _, _ = smoke
    shapes = jax.eval_shape(lambda k: jax_init(jcfg, k)[0], jax.random.PRNGKey(0))
    want = {n: tuple(s.shape[1:]) if n.startswith("blocks.") else tuple(s.shape)
            for n, s in _flat(shapes)}
    got = {}
    for n, p in T.init_model(cfg, device="meta").named_parameters():
        key = n if not n.startswith("blocks.") else "blocks." + n.split(".", 2)[2]
        got[key] = tuple(p.shape)
    assert got == want
    assert "blocks.ff.experts.wi_gate" in got and "blocks.ff.router" in got


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_smoke_forward_matches_jax(smoke):
    jcfg, cfg, jp, model, toks = smoke
    want, _ = jax_forward(jcfg, JRUN, jp, {"tokens": jnp.asarray(toks)})
    got, _ = T.forward(cfg, T.RunCfg(), model, {"tokens": torch.from_numpy(toks)})
    assert _rel(got.numpy(), want) <= 2e-5


def test_smoke_prefill_and_greedy_decode_match_jax(smoke):
    jcfg, cfg, jp, model, toks = smoke
    run, steps = T.RunCfg(), 6
    jl, jc = jax_prefill(jcfg, JRUN, jp, {"tokens": jnp.asarray(toks)}, t_max=16 + steps)
    pl, pc = T.prefill(cfg, run, model, {"tokens": torch.from_numpy(toks)},
                       t_max=16 + steps)
    for _ in range(steps):
        assert _rel(pl.numpy(), jl) <= 2e-5
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        pt = pl[:, -1].argmax(-1)[:, None]
        assert np.array_equal(np.asarray(jt), pt.numpy())
        jl, jc = jax_decode(jcfg, JRUN, jp, jc, jt)
        pl, pc = T.decode_step(cfg, run, model, pc, pt)
    assert _rel(pl.numpy(), jl) <= 2e-5


def test_smoke_lm_loss_and_gradients_match_jax(smoke):
    jcfg, cfg, jp, model, toks = smoke
    loss_j, gj = jax.value_and_grad(
        lambda p: jax_lm_loss(jcfg, JRUN, p, {"tokens": jnp.asarray(toks)}))(jp)
    model.requires_grad_(True)
    try:
        loss = T.lm_loss(cfg, T.RunCfg(), model, {"tokens": torch.from_numpy(toks)})
        names, leaves = zip(*model.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    finally:
        model.requires_grad_(False)
    assert abs(float(loss.detach()) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = port_leaves(jax.tree.map(np.asarray, gj))
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert _rel(g.numpy(), want[name]) <= 1e-4, name


def test_routing_replay_pins_the_expert_choices(smoke):
    # a run's expert choices recorded on one device, replayed onto the same
    # run (the same bits, no flip) and onto a perturbed router (its own
    # top-k flips; the replay holds it to the recorded one)
    _, cfg, _, model, toks = smoke
    run, batch = T.RunCfg(), {"tokens": torch.from_numpy(toks)}
    M.routing = {"record": []}
    try:
        want, _ = T.forward(cfg, run, model, batch)
        record = M.routing["record"]
    finally:
        M.routing = None
    assert len(record) == cfg.n_layers
    assert record[0].shape == (2, 16, cfg.moe.top_k)
    M.routing = {"replay": record, "at": 0, "flips": 0, "tokens": 0}
    try:
        got, _ = T.forward(cfg, run, model, batch)
        assert torch.equal(got, want) and M.routing["at"] == cfg.n_layers
        assert int(M.routing["flips"]) == 0 and M.routing["tokens"] == 2 * 16 * cfg.n_layers
    finally:
        M.routing = None
    m = T.moe_dims(cfg)
    p = T._cast_f(model.blocks[0].ff, None)
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(3))
    own = M.route(x.reshape(-1, cfg.d_model), p["router"], m)[1]
    other = torch.roll(own, 1, dims=-1) % cfg.moe.n_experts     # another order
    other[:, 0] = (other[:, 0] + 1) % cfg.moe.n_experts          # another choice
    other[:, 1] = torch.where(other[:, 1] == other[:, 0],
                              (other[:, 1] + 1) % cfg.moe.n_experts, other[:, 1])
    M.routing = {"replay": [], "at": 0, "flips": 0, "tokens": 0}
    try:
        top_p, top_e = M.route(x.reshape(-1, cfg.d_model), p["router"], m, other)
        assert torch.equal(top_e, other) and int(M.routing["flips"]) == 32
    finally:
        M.routing = None
    probs = torch.softmax(x.reshape(-1, cfg.d_model) @ p["router"], -1)
    w = probs.gather(-1, other)
    assert torch.allclose(top_p, w / w.sum(-1, keepdim=True))


def test_launchers_run_the_moe_smoke_config(capsys):
    toks = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen", "3"])
    assert toks.shape == (2, 3)
    losses = train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "prefill 8 tokens x2" in out and "step     1 loss" in out and "[done]" in out
    assert len(losses) == 2 and all(np.isfinite(losses))


# --------------------------------------------------------------------------
# checkpoints across packages (the JAX trainer in child processes)
# --------------------------------------------------------------------------

STEPS, EVERY, HALT = 4, 2, 3       # checkpoints at steps 0 and 2, halted after 3
COMMON = ["--arch", ARCH, "--smoke", "--steps", str(STEPS), "--batch", "4", "--seq",
          "32", "--ckpt-every", str(EVERY), "--log-every", "1"]


def _jax_train(extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-m", "repro.launch.train", *COMMON, *extra],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return out


def _losses(stdout):
    return {int(line.split()[1]): float(line.split()[3])
            for line in stdout.splitlines() if line.startswith("step")}


def test_each_package_resumes_the_others_moe_checkpoint(tmp_path):
    ck_jax, ck_port = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ref = _jax_train([])
    jax_halt = _jax_train(["--ckpt-dir", ck_jax, "--halt-after", str(HALT)])
    quiet = io.StringIO()
    with contextlib.redirect_stdout(quiet):
        port_ref = dict(enumerate(train.main(COMMON + ["--device", "cpu"])))
        train.main(COMMON + ["--device", "cpu", "--ckpt-dir", ck_port,
                             "--halt-after", str(HALT)])
    jax_from_port = _jax_train(["--ckpt-dir", ck_port])
    _finish(jax_halt)
    with contextlib.redirect_stdout(quiet):
        port_from_jax = train.main(COMMON + ["--device", "cpu", "--ckpt-dir", ck_jax])
    assert f"[resume] from step {EVERY}" in quiet.getvalue()
    ref_j = _losses(_finish(jax_ref))
    got_j = _losses(_finish(jax_from_port))
    # the step after the latest checkpoint (step 2), in the other package
    assert sorted(got_j) == [3] and len(port_from_jax) == 1
    assert abs(got_j[3] - port_ref[3]) < 1e-4, (got_j, port_ref)
    assert abs(port_from_jax[0] - ref_j[3]) < 1e-4, (port_from_jax, ref_j)
