"""deepseek-v2-lite sharded over rank processes, against the port on one
device and against the JAX package, on the CPU (gloo ranks, f32, 1e-5).

The SMOKE config (a dense ``first_blocks`` block, then MLA + MoE blocks
with a shared expert), the port's weights from seed 0 carried into the
JAX package's tree.  JAX runs once on one device in this process (its
loss, gradients and greedy serving); then one spawn of 4 ranks on 2x2
(data 2, model 2) runs every case.  Held, for the dense MoE (the
config's ``impl``: rows gathered over ``data``, each rank its experts'
share) and the expert-parallel one (``impl="ep"``, ``chunks=4``, its
dispatch and combine all-to-alls over ``model``):

* the loss and the gradients gathered whole, against one device and
  against JAX: the MLA's heads cut over ``model`` (``wq``, ``w_uk``,
  ``w_uv``, ``wo``), its latents (``w_dkv``, ``w_kr``, ``kv_norm``) whole
  there with their gradients summed over it, the leading dense block
  gathered by its own specs (FSDP), the shared expert's MLP cut over
  ``model``;
* greedy serving of 4 rows (2 a rank over ``data``; the compressed cache
  cut over ``data`` only) and of 1 row (whole on every rank): the same
  tokens, logits within 1e-5;
* ``launch/serve.py`` and ``launch/train.py`` as each rank of ``--mesh
  2x2``: the tokens and losses of one device; a checkpoint written on one
  device resumed on 2x2 and one written on 2x2 resumed on one device
  (``first_blocks`` its own stacked tensor in the JAX trainer's tree).
"""

import dataclasses
import os
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
from repro_torch.launch import serve, train
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax_sharded, params_to_jax_tree

ARCH = "deepseek-v2-lite-16b"
IMPLS = ("dense", "ep")
GEN, PROMPT = 4, 12
TOL = 1e-5
SERVE = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4", "--prompt-len", "8",
         "--gen", "4"]
TRAIN = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
         "--seq", "16", "--log-every", "1"]


@pytest.fixture(autouse=True, scope="module")
def _share_the_host():
    # the driver runs test files side by side, one a core or so: torch's
    # pool on every core then spends its time waiting on the others
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _cfg(impl):
    cfg = get_config(ARCH, smoke=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl=impl, chunks=4 if impl == "ep" else 1))


def _tokens(cfg):
    return np.random.RandomState(3).randint(0, cfg.vocab, (4, 16)).astype(np.int32)


def _serving(cfg, run, model, toks):
    """Greedy serving of all rows and of the first: tokens, logits and
    the shapes of this rank's cache."""
    out = {}
    for key, rows in (("all", toks), ("one", toks[:1])):
        r = serve.generate(cfg, run, model, rows[:, :PROMPT], GEN, keep_logits=True)
        out[key] = {"tokens": r["tokens"].numpy(),
                    "logits": [x.numpy() for x in r["logits"]],
                    "cache": {k: tuple(r["cache"][k].shape) for k in ("k", "v")}}
    return out


def _loss_grads(cfg, run, model, toks):
    model.requires_grad_(True)
    loss = T.lm_loss(cfg, run, model, {"tokens": T.local_rows(toks, run)})
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    model.requires_grad_(False)
    if run.mesh is not None:
        grads = C.gather_full(grads, T.param_specs(cfg, run.mesh))
    return float(loss.detach()), {n: g.numpy() for n, g in grads.items()}


# --------------------------------------------------------------------------
# the port's ranks
# --------------------------------------------------------------------------


def _ranks(ctx, tree, dirs):
    M.share_host(ctx)
    toks = torch.from_numpy(_tokens(_cfg("dense")))
    out = {}
    for impl in IMPLS:
        cfg = _cfg(impl)
        run = T.RunCfg(mesh=M.mesh_of(ctx), remat=False)
        model = params_from_jax_sharded(cfg, tree, run.mesh, device="cpu")
        calls = C.calls["all_to_all"]
        loss, grads = _loss_grads(cfg, run, model, toks)
        out[impl] = {"loss": loss, "grads": grads, "serve": _serving(cfg, run, model, toks),
                     "all_to_alls": C.calls["all_to_all"] - calls,
                     "tp": T.attn_tp(cfg, run).axes,
                     "wq": tuple(model.blocks[0].attn.wq.shape),
                     "w_dkv": tuple(model.blocks[0].attn.w_dkv.shape)}
    out["serve_main"] = serve.serve(serve.parse_args(SERVE + ["--mesh", "2x2"]), ctx)
    out["from_1x1"] = train.train(train.parse_args(
        TRAIN + ["--mesh", "2x2", "--ckpt-dir", dirs["1x1"]]), ctx)
    out["writes"] = train.train(train.parse_args(
        TRAIN + ["--mesh", "2x2", "--ckpt-dir", dirs["2x2"], "--ckpt-every", "1",
                 "--halt-after", "1"]), ctx)
    return out


# --------------------------------------------------------------------------
# the runs, once for the module
# --------------------------------------------------------------------------


def _jax_side(tree, toks):
    """JAX on one device with the params ``tree``: the loss and its
    gradients, and greedy serving of all rows and of the first."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models.transformer import RunCfg as JaxRun
    from repro.models.transformer import decode_step as jax_decode
    from repro.models.transformer import lm_loss as jax_lm_loss
    from repro.models.transformer import prefill as jax_prefill
    from repro_torch.models.convert import port_leaves

    jcfg, run = jax_config(ARCH, smoke=True), JaxRun(mesh=None, remat=False)
    jp = jax.tree.map(jnp.asarray, tree)
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(jcfg, run, p, {"tokens": jnp.asarray(toks)})))(jp)
    prefill = jax.jit(lambda p, t: jax_prefill(jcfg, run, p, {"tokens": t},
                                               t_max=PROMPT + GEN))
    decode = jax.jit(lambda p, c, t: jax_decode(jcfg, run, p, c, t))
    served = {}
    for key, rows in (("all", toks), ("one", toks[:1])):
        logits, cache = prefill(jp, jnp.asarray(rows[:, :PROMPT]))
        kept, out = [np.asarray(logits)], []
        for i in range(GEN):
            tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
            out.append(np.asarray(tok))
            if i < GEN - 1:
                logits, cache = decode(jp, cache, tok)
                kept.append(np.asarray(logits))
        served[key] = {"tokens": np.concatenate(out, 1), "logits": kept}
    return {"loss": float(loss), "grads": port_leaves(jax.tree.map(np.asarray, g)),
            "serve": served}


@pytest.fixture(scope="module")
def runs():
    cfg = _cfg("dense")
    toks = _tokens(cfg)
    model = T.init_model(cfg, seed=0, device="cpu")
    tree = _numpy(params_to_jax_tree(dict(model.named_parameters())))
    jres = _jax_side(tree, toks)
    run = T.RunCfg(remat=False)
    loss, grads = _loss_grads(cfg, run, model, torch.from_numpy(toks))
    one = {"loss": loss, "grads": grads, "serve": _serving(cfg, run, model,
                                                           torch.from_numpy(toks)),
           "serve_main": serve.main(SERVE).numpy(), "train_main": train.main(TRAIN)}
    tmp = tempfile.mkdtemp()
    dirs = {k: os.path.join(tmp, k) for k in ("1x1", "2x2")}
    # step 0's checkpoint of each grid, resumed on the other for step 1
    train.main(TRAIN + ["--ckpt-dir", dirs["1x1"], "--ckpt-every", "1", "--halt-after", "1"])
    got = dist.run_ranks(_ranks, 2, 2, device="cpu", args=(tree, dirs))
    one["from_2x2"] = train.main(TRAIN + ["--ckpt-dir", dirs["2x2"]])
    return got, one, jres


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------


def _same_serving(got, want):
    for key in ("all", "one"):
        g, w = got[key], want[key]
        assert np.array_equal(g["tokens"], w["tokens"].astype(g["tokens"].dtype)), key
        assert len(g["logits"]) == len(w["logits"]) == GEN
        for a, b in zip(g["logits"], w["logits"]):
            assert a.shape == b.shape and _rel(a, b) <= TOL, key


def test_one_device_matches_jax(runs):
    _, one, jres = runs
    assert abs(one["loss"] - jres["loss"]) <= TOL * abs(jres["loss"])
    assert set(one["grads"]) == set(jres["grads"])
    for name, g in one["grads"].items():
        assert _rel(g, jres["grads"][name]) <= TOL, name
    _same_serving(one["serve"], jres["serve"])


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_gradients_on_2x2_match_one_device_and_jax(runs, impl):
    got, one, jres = runs
    for want in (one, jres):
        for r in got:
            assert abs(r[impl]["loss"] - want["loss"]) <= TOL * abs(want["loss"])
        grads = got[0][impl]["grads"]
        assert set(grads) == set(want["grads"])
        for name, g in grads.items():
            assert _rel(g, want["grads"][name]) <= TOL, name


@pytest.mark.parametrize("impl", IMPLS)
def test_serving_on_2x2_matches_one_device_and_jax(runs, impl):
    # 4 rows (2 a rank) and 1 row (whole on every rank), every rank the
    # global batch's tokens and logits
    got, one, jres = runs
    for r in got:
        _same_serving(r[impl]["serve"], one["serve"])
        _same_serving(r[impl]["serve"], jres["serve"])


@pytest.mark.parametrize("impl", IMPLS)
def test_mla_heads_cut_over_model_and_the_cache_over_data(runs, impl):
    got, _, _ = runs
    cfg = _cfg(impl)
    m = cfg.mla
    for r in got:
        res = r[impl]
        assert res["tp"] == ("model",)
        assert res["wq"] == (cfg.d_model // 2, cfg.n_heads // 2,
                             m.qk_nope_dim + m.qk_rope_dim)
        assert res["w_dkv"] == (cfg.d_model // 2, m.kv_lora_rank)  # FSDP only
        t = PROMPT + GEN
        for key, rows in (("all", 2), ("one", 1)):
            assert res["serve"][key]["cache"] == {"k": (cfg.n_layers, rows, t, m.kv_lora_rank),
                                                  "v": (cfg.n_layers, rows, t, m.qk_rope_dim)}
        assert (res["all_to_alls"] > 0) == (impl == "ep")


def test_launchers_on_2x2_give_one_devices_tokens_and_losses(runs):
    got, one, _ = runs
    assert np.array_equal(got[0]["serve_main"], one["serve_main"])
    step0 = one["train_main"][0]
    assert len(got[0]["writes"]) == 1 and abs(got[0]["writes"][0] - step0) <= TOL * abs(step0)


def test_checkpoints_resume_across_one_device_and_2x2(runs):
    got, one, _ = runs
    step1 = one["train_main"][1]
    assert len(got[0]["from_1x1"]) == len(one["from_2x2"]) == 1
    assert abs(got[0]["from_1x1"][0] - step1) <= TOL * abs(step1)
    assert abs(one["from_2x2"][0] - step1) <= TOL * abs(step1)
