"""The port's expert parallelism over rank processes, against the JAX
package and against the port on one device, on the CPU (gloo ranks, f32).

The JAX side runs first, on 4 fake devices in a child process (this file
run as a script), and writes the weights both sides use; then one spawn of
4 ranks on 2x2 (data 2, model 2), re-cut to 4x1 for the 4-rank all-to-all.
Held:

* ``collectives.all_to_all`` over ``data``, ``model`` and both at once on
  2x2, and over ``data`` on 4 ranks: forward bitwise the blocks' exchange
  (f32, and bf16 blocks of an odd byte count), backward the reverse
  exchange of the gradient;
* ``apply_moe_ep`` (E=8, k=2, d 32, 64 tokens a step, a routing skewed
  so that pairs drop at capacity factor 1.25) with 1 and 4 chunks against
  the JAX package's ``apply_moe_ep`` on a 2x2 mesh: the output and the
  gradients of a weighted sum of it (input, router, experts) within 1e-5
  of their max, the drops asserted present; at 8.0 JAX's expert-parallel
  gradients equal its own dense ones (1e-5), so its ``shard_map`` with
  ``check_vma=False`` is no fault of the reference;
* qwen3-moe's SMOKE config on 2x2 against the port on one device at
  capacity factor 8.0 (nothing drops), the dense MoE (the config's
  ``impl``: the rows gathered over ``data``, each rank its experts'
  share) and the expert-parallel one (``impl="ep"``, ``chunks=4``): the
  loss (1e-5 relative) and the gathered gradients (1e-4 of each leaf's
  max), greedy serving (the same tokens, logits 1e-5; again with the
  1x1 run's expert choices replayed, each rank its rows); remat (a
  checkpoint a layer around the expert-parallel chunks' own) changes no
  bit of the loss and the gradients;
* a shared expert beside the expert parallelism (its MLP's hidden dim
  cut over ``model``), the port's own weights from one seed on 2x2 and on
  one device: the loss, the gathered gradients and serving as above;
* ``serve --mesh 2x2`` (the launcher's ``serve`` as each rank) gives the
  1x1 tokens; a batch of one row on 2x2 (decode with the batch whole on
  every rank, the dense MoE over ``model``) gives the 1x1 tokens and
  logits.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch import dist
from repro_torch.configs import get_config
from repro_torch.distributed import collectives as C
from repro_torch.launch import mesh as M
from repro_torch.launch import serve
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, params_from_jax_sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-moe-30b-a3b"
DIMS = dict(d_model=32, n_experts=8, top_k=2, d_ff_expert=16)
XSHAPE = (4, 16, 32)
CHUNKS = (1, 4)
CF = 1.25
GEN, PROMPT = 5, 12


def _moe_inputs():
    """The MoE's input (a shift common to every token skews the routing)
    and the weights of the summed output whose gradients are compared."""
    x = (np.random.RandomState(1).randn(*XSHAPE) + 0.5).astype(np.float32)
    r = np.random.RandomState(9).randn(*XSHAPE).astype(np.float32)
    return x, r


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


# --------------------------------------------------------------------------
# the JAX side: apply_moe_ep on 4 fake devices (a child process)
# --------------------------------------------------------------------------


def _jax_ep(out: str) -> None:
    from repro.launch.mesh import ensure_host_devices
    ensure_host_devices(4)
    import jax
    import jax.numpy as jnp

    from repro.compat import make_mesh
    from repro.configs import get_config as jax_config
    from repro.models import moe as JM
    from repro.models.common import Initializer
    from repro.models.transformer import init_model as jax_init
    from repro_torch.models.convert import port_leaves

    mesh = make_mesh((2, 2), ("data", "model"))
    x, r = _moe_inputs()
    res = {}
    for cf in (CF, 8.0):
        m = JM.MoEDims(**DIMS, capacity_factor=cf)
        p = JM.init_moe(Initializer(key=jax.random.PRNGKey(0), dtype=jnp.float32), m)
        if cf == CF:
            for name, leaf in port_leaves(jax.tree.map(np.asarray, p)).items():
                res[f"param/{name}"] = leaf
        for chunks in CHUNKS + (0,):           # 0: the dense apply_moe
            def f(pp, xx):
                if chunks:
                    return JM.apply_moe_ep(pp, m, xx, mesh, chunks=chunks)
                return JM.apply_moe(pp, m, xx)
            y = jax.jit(f)(p, jnp.asarray(x))
            gp, gx = jax.jit(jax.grad(lambda pp, xx: jnp.sum(f(pp, xx) * r),
                                      argnums=(0, 1)))(p, jnp.asarray(x))
            key = f"{cf}/{chunks}"
            res[f"{key}/out"] = np.asarray(y)
            res[f"{key}/dx"] = np.asarray(gx)
            for name, g in port_leaves(jax.tree.map(np.asarray, gp)).items():
                res[f"{key}/d/{name}"] = g
    # qwen3-moe's SMOKE params for the ranks and the parent
    jp = jax_init(jax_config(ARCH, smoke=True), jax.random.PRNGKey(0))[0]
    for name, leaf in port_leaves(jax.tree.map(np.asarray, jp)).items():
        res[f"smoke/{name}"] = leaf
    np.savez(out, **res)


# --------------------------------------------------------------------------
# the port's ranks
# --------------------------------------------------------------------------


def _all_to_all(ctx, axes_list):
    """all_to_all over each entry of ``axes_list``: rank-major blocks
    exchanged bitwise, the backward the reverse exchange."""
    mesh = M.mesh_of(ctx)
    out = {}
    for axes in axes_list:
        axes = (axes,) if isinstance(axes, str) else axes
        sizes = [mesh.shape[a] for a in axes]
        p = int(np.prod(sizes))
        me = int(np.ravel_multi_index([mesh.coords[a] for a in axes], sizes))

        def block(src, dst):  # what rank src (in the group) sends to dst
            return torch.arange(6.0).reshape(2, 3) + 100 * src + 10 * dst

        x = torch.cat([block(me, j) for j in range(p)]).requires_grad_()
        y = C.all_to_all(x, axes)
        ok = torch.equal(y.detach(), torch.cat([block(j, me) for j in range(p)]))
        wts = torch.arange(float(y.numel())).reshape(y.shape) * (me + 1)
        (y * wts).sum().backward()
        # block j of x went to rank j, whose weights on source me's block
        # are its own weights' block me
        want = torch.cat([(torch.arange(float(y.numel())).reshape(y.shape)
                           * (j + 1))[me * 2:(me + 1) * 2] for j in range(p)])
        # bf16 blocks of 3 elements: 6 bytes, carried in two padded words
        b16 = torch.cat([block(me, j)[:1].bfloat16() for j in range(p)])
        ok = ok and torch.equal(C.all_to_all(b16, axes),
                                torch.cat([block(j, me)[:1].bfloat16() for j in range(p)]))
        out["/".join(axes) + f"/{p}"] = ok and torch.equal(x.grad, want)
    return out


def _gathered(t, axes, dim):
    return C.all_gather(t, axes, dim) if axes else t


def _ep_grads(ctx, jres, cf, chunks):
    """The port's apply_moe_ep on this rank (its rows over ``data``, its
    experts over ``model``) and its gradients, gathered whole."""
    mesh = M.mesh_of(ctx)
    dc, mc, msize = mesh.coords["data"], mesh.coords["model"], mesh.shape["model"]
    m = MOE.MoEDims(**DIMS, capacity_factor=cf)
    e_loc = m.n_experts // msize
    b_loc = XSHAPE[0] // mesh.shape["data"]
    x, r = _moe_inputs()
    rows = slice(dc * b_loc, (dc + 1) * b_loc)
    router = torch.from_numpy(jres[f"param/router"][:, mc * e_loc:(mc + 1) * e_loc].copy())
    experts = {k: torch.from_numpy(jres[f"param/experts.{k}"][mc * e_loc:(mc + 1) * e_loc]
                                   .copy()).requires_grad_()
               for k in ("wi_gate", "wi_up", "wo")}
    router.requires_grad_()
    xl = torch.from_numpy(x[rows].copy()).requires_grad_()
    whole = C.gather_packed([router], [1], "model")[0]
    y, drops = MOE.count_drops(lambda: MOE.apply_moe_ep(
        {"router": whole, "experts": experts}, m, xl, model_axes=("model",), chunks=chunks))
    (y * torch.from_numpy(r[rows])).sum().backward()
    # the data groups' shares summed, the model blocks gathered
    grads = {"router": _gathered(C.all_reduce(router.grad, "data"), "model", 1)}
    for k, t in experts.items():
        grads[f"experts.{k}"] = _gathered(C.all_reduce(t.grad, "data"), "model", 0)
    return {"out": _gathered(y.detach(), "data", 0).numpy(),
            "dx": _gathered(xl.grad, "data", 0).numpy(),
            "grads": {n: g.numpy() for n, g in grads.items()}, "drops": drops}


def _smoke(ctx, params, toks, cfg, routing):
    """lm_loss and its gathered gradients, and greedy serving, of ``cfg``
    on this rank's mesh."""
    run = T.RunCfg(mesh=M.mesh_of(ctx), remat=False)
    model = params_from_jax_sharded(cfg, params, run.mesh, device="cpu")
    model.requires_grad_(True)
    loss = T.lm_loss(cfg, run, model, {"tokens": T.local_rows(toks, run)})
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    full = C.gather_full(grads, T.param_specs(cfg, run.mesh))
    # remat (a checkpoint a layer around the chunks' own) changes no bit
    rcfg = dataclasses.replace(cfg, remat=True)
    loss_r = T.lm_loss(rcfg, dataclasses.replace(run, remat=True), model,
                       {"tokens": T.local_rows(toks, run)})
    same = bool(torch.equal(loss, loss_r)) and all(
        torch.equal(g, r) for g, r in zip(grads.values(), torch.autograd.grad(loss_r, leaves)))
    model.requires_grad_(False)
    calls = C.calls["all_to_all"]
    # the 1x1 run's expert choices replayed: the 1x1 logits, no flip
    MOE.routing = {"replay": [torch.from_numpy(a) for a in routing], "at": 0, "flips": 0,
                   "tokens": 0}
    try:
        pinned = serve.generate(cfg, run, model, toks[:, :PROMPT], GEN, keep_logits=True)
        flips = int(MOE.routing["flips"])
    finally:
        MOE.routing = None
    r = serve.generate(cfg, run, model, toks[:, :PROMPT], GEN, keep_logits=True)
    one = serve.generate(cfg, run, model, toks[:1, :PROMPT], GEN, keep_logits=True)
    return {"loss": float(loss.detach()), "grads": {n: g.numpy() for n, g in full.items()},
            "tokens": r["tokens"].numpy(), "logits": [x.numpy() for x in r["logits"]],
            "all_to_alls": C.calls["all_to_all"] - calls, "remat_bitwise": same,
            "pinned_logits": [x.numpy() for x in pinned["logits"]], "flips": flips,
            "one_tokens": one["tokens"].numpy(),
            "one_logits": [x.numpy() for x in one["logits"]]}


def _shared_expert(ctx, toks):
    """The expert-parallel smoke config with a shared expert (its MLP's
    hidden dim cut over ``model``), the port's own weights from a seed:
    the loss, its gathered gradients and greedy serving."""
    cfg = _shared_cfg()
    run, model, _ = M.rank_setup(cfg, ctx, "cpu", seed=5, remat=False)
    model.requires_grad_(True)
    loss = T.lm_loss(cfg, run, model, {"tokens": T.local_rows(toks, run)})
    names, leaves = zip(*model.named_parameters())
    grads = C.gather_full(dict(zip(names, torch.autograd.grad(loss, leaves))),
                          T.param_specs(cfg, run.mesh))
    model.requires_grad_(False)
    r = serve.generate(cfg, run, model, toks[:, :PROMPT], GEN, keep_logits=True)
    return {"loss": float(loss.detach()), "grads": {n: g.numpy() for n, g in grads.items()},
            "tp": T.mlp_tp(cfg, run, "ff.shared.").axes,
            "logits": [x.numpy() for x in r["logits"]], "tokens": r["tokens"].numpy()}


def _shared_cfg():
    cfg = get_config(ARCH, smoke=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl="ep", chunks=2, n_shared=1, d_ff_shared=48))


def _ranks(ctx, npz, routing):
    M.share_host(ctx)
    with np.load(npz) as z:
        jres = dict(z)
    out = {"all_to_all": _all_to_all(ctx, ["data", "model", ("data", "model")])}
    out["ep"] = {(cf, c): _ep_grads(ctx, jres, cf, c) for cf in (CF, 8.0) for c in CHUNKS}
    cfg = get_config(ARCH, smoke=True)
    params = _smoke_tree(jres)
    toks = torch.from_numpy(_tokens(cfg))
    out["dense"] = _smoke(ctx, params, toks, cfg, routing)
    out["ep_model"] = _smoke(ctx, params, toks, _ep_cfg(cfg), routing)
    out["shared"] = _shared_expert(ctx, toks)
    out["serve"] = serve.serve(serve.parse_args(["--arch", ARCH, "--smoke", "--device",
                                                 "cpu", "--mesh", "2x2"]), ctx)
    ctx = M.regrid_mesh({"data": 4, "model": 1})
    out["all_to_all"].update(_all_to_all(ctx, ["data"]))
    return out


def _ep_cfg(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="ep", chunks=4))


def _smoke_tree(jres):
    from repro_torch.models.convert import put_path

    tree: dict = {}
    for key, leaf in jres.items():
        if key.startswith("smoke/"):
            name = key[len("smoke/"):]
            if name.startswith("blocks."):
                continue
            put_path(tree, name.split("."), leaf)
    # the blocks stacked again on their leading layer axis
    layers: dict = {}
    for key, leaf in jres.items():
        if key.startswith("smoke/blocks."):
            _, i, rest = key[len("smoke/"):].split(".", 2)
            layers.setdefault(rest, {})[int(i)] = leaf
    for rest, by in layers.items():
        put_path(tree, ["blocks"] + rest.split("."), np.stack([by[i] for i in sorted(by)]))
    return tree


def _tokens(cfg):
    return np.random.RandomState(3).randint(0, cfg.vocab, (4, 16)).astype(np.int32)


# --------------------------------------------------------------------------
# the runs, once for the module
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs():
    tmp = tempfile.mkdtemp()
    npz = os.path.join(tmp, "jax_ep.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), npz], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(npz) as z:
        jres = dict(z)
    # the port on one device
    cfg = get_config(ARCH, smoke=True)
    model = params_from_jax(cfg, _smoke_tree(jres), device="cpu")
    toks = torch.from_numpy(_tokens(cfg))
    run = T.RunCfg(remat=False)
    model.requires_grad_(True)
    loss = T.lm_loss(cfg, run, model, {"tokens": toks})
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    model.requires_grad_(False)
    MOE.routing = {"record": []}
    try:
        one = serve.generate(cfg, run, model, toks[:, :PROMPT], GEN, keep_logits=True)
        routing = [t.numpy() for t in MOE.routing["record"]]
    finally:
        MOE.routing = None
    single = serve.generate(cfg, run, model, toks[:1, :PROMPT], GEN, keep_logits=True)
    want = {"loss": float(loss.detach()), "grads": {n: g.numpy() for n, g in grads.items()},
            "tokens": one["tokens"].numpy(), "logits": [x.numpy() for x in one["logits"]],
            "one_tokens": single["tokens"].numpy(),
            "one_logits": [x.numpy() for x in single["logits"]],
            "serve": serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"]).numpy()}
    scfg = _shared_cfg()
    smodel = T.init_model(scfg, seed=5, device="cpu")
    smodel.requires_grad_(True)
    sloss = T.lm_loss(scfg, run, smodel, {"tokens": toks})
    names, leaves = zip(*smodel.named_parameters())
    sgrads = dict(zip(names, torch.autograd.grad(sloss, leaves)))
    smodel.requires_grad_(False)
    sr = serve.generate(scfg, run, smodel, toks[:, :PROMPT], GEN, keep_logits=True)
    want["shared"] = {"loss": float(sloss.detach()),
                      "grads": {n: g.numpy() for n, g in sgrads.items()},
                      "logits": [x.numpy() for x in sr["logits"]],
                      "tokens": sr["tokens"].numpy()}
    got = dist.run_ranks(_ranks, 2, 2, device="cpu", args=(npz, routing))
    return got, jres, want


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------


def test_all_to_all_on_2_and_4_ranks(runs):
    got, _, _ = runs
    checks = got[0]["all_to_all"]
    assert sorted(checks) == ["data/2", "data/4", "data/model/4", "model/2"]
    for r in got:
        assert all(r["all_to_all"].values()), r["all_to_all"]


@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("cf", [CF, 8.0])
def test_apply_moe_ep_and_its_gradients_match_jax_on_2x2(runs, cf, chunks):
    got, jres, _ = runs
    key = f"{cf}/{chunks}"
    for r in got:
        ep = r["ep"][(cf, chunks)]
        assert (ep["drops"] > 0) == (cf == CF), ep["drops"]
        assert _rel(ep["out"], jres[f"{key}/out"]) <= 1e-5
        assert _rel(ep["dx"], jres[f"{key}/dx"]) <= 1e-5
        for name, g in ep["grads"].items():
            assert _rel(g, jres[f"{key}/d/{name}"]) <= 1e-5, name


def test_jax_ep_gradients_equal_its_dense_ones_where_nothing_drops(runs):
    _, jres, _ = runs
    for chunks in CHUNKS:
        for name in ("dx", "d/router", "d/experts.wi_gate", "d/experts.wi_up",
                     "d/experts.wo", "out"):
            assert _rel(jres[f"8.0/{chunks}/{name}"], jres[f"8.0/0/{name}"]) <= 1e-5, name


@pytest.mark.parametrize("impl", ["dense", "ep_model"])
def test_smoke_loss_gradients_and_serving_on_2x2_match_one_device(runs, impl):
    got, _, want = runs
    r = got[0][impl]
    assert abs(r["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert set(r["grads"]) == set(want["grads"])
    for name, g in r["grads"].items():
        assert _rel(g, want["grads"][name]) <= 1e-4, name
    assert np.array_equal(r["tokens"], want["tokens"].astype(r["tokens"].dtype))
    for a, b in zip(r["logits"], want["logits"]):
        assert a.shape == b.shape and _rel(a, b) <= 1e-5
    # the expert-parallel serving dispatches in all-to-alls; the dense one not
    assert (r["all_to_alls"] > 0) == (impl == "ep_model")
    assert r["remat_bitwise"]
    # the 1x1 run's expert choices replayed (each rank its rows): no flip
    assert r["flips"] == 0
    for a, b in zip(r["pinned_logits"], want["logits"]):
        assert _rel(a, b) <= 1e-5


@pytest.mark.parametrize("impl", ["dense", "ep_model"])
def test_one_row_on_2x2_decodes_as_one_device(runs, impl):
    got, _, want = runs
    for r in got:
        assert np.array_equal(r[impl]["one_tokens"], want["one_tokens"])
        for a, b in zip(r[impl]["one_logits"], want["one_logits"]):
            assert a.shape == b.shape and _rel(a, b) <= 1e-5


def test_shared_expert_on_2x2_matches_one_device(runs):
    # the port's own weights from one seed on both sides: the shared
    # expert's MLP tensor-parallel over model beside the expert parallelism
    got, _, want = runs
    r, w = got[0]["shared"], want["shared"]
    assert r["tp"] == ("model",)
    assert abs(r["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"])
    assert set(r["grads"]) == set(w["grads"]) and "blocks.0.ff.shared.wo" in r["grads"]
    for name, g in r["grads"].items():
        assert _rel(g, w["grads"][name]) <= 1e-4, name
    assert np.array_equal(r["tokens"], w["tokens"])
    for a, b in zip(r["logits"], w["logits"]):
        assert a.shape == b.shape and _rel(a, b) <= 1e-5


def test_serve_on_2x2_gives_the_1x1_tokens(runs):
    got, _, want = runs
    assert np.array_equal(got[0]["serve"], want["serve"])


if __name__ == "__main__":
    _jax_ep(sys.argv[1])
