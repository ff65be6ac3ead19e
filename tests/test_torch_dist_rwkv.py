"""rwkv6-3b served over rank processes, against the port on one device and
against the JAX package, on the CPU (gloo ranks, f32, 1e-5).

The SMOKE config (2 layers, d 64, 4 heads of 16, d_ff 128), the port's
weights from seed 0 carried into the JAX package's tree (``w0``, ``ln_w``
and ``ln_b``, constant at init, made random).  JAX serves once
on one device in this process; then one spawn of 4 ranks on 2x2 (data 2,
model 2) serves 4 rows (2 a rank over ``data``) and 1 row (whole on every
rank), greedy:

* each step's logits (the prefill's and every decode step's) and the
  tokens against one device and against JAX, within 1e-5;
* the decode states gathered whole (``x_tm``, ``x_cm`` over ``data``;
  ``wkv`` over ``data`` and its heads over ``model``) against one
  device's and JAX's;
* each rank's heads: 2 of the 4 (``Wr`` cut over ``model``), the decay,
  the bonus and the group norm taken at its own heads' columns, and its
  part of ``wkv`` (L, B/2, 2, K, K);
* ``launch/serve.py`` as each rank of ``--mesh 2x2``: one device's tokens;
* in bf16, every rank's logits bit for bit those of one device whose
  row-parallel products (``Wo``, the channel mix's ``Wv``) run in two
  halves of their rows, each rounded to bf16 and summed in rank order;
* training: one AdamW step of the global batch (2 rows a rank over
  ``data``), its loss within 1e-6 and its gradients and updated params
  (gathered whole) within 1e-5 of one device's and of JAX's; every leaf
  whole over ``model`` (the time mix's decay, bonus and group norm, whose
  products reach one rank's heads only, the lerps, the layer norms) with
  the same gradient and params, bit for bit, on the two ranks of each
  ``model`` pair; ``launch/train.py`` as each rank of ``--mesh 2x2``: one
  device's losses.
"""

import dataclasses

import numpy as np
import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch import dist
from repro_torch.configs import get_config
from repro_torch.distributed import collectives as C
from repro_torch.launch import mesh as M
from repro_torch.distributed import sharding as SH
from repro_torch.launch import serve, train
from repro_torch.models import rwkv as RW
from repro_torch.models import transformer as T
from repro_torch.models.convert import (params_from_jax, params_from_jax_sharded,
                                        params_to_jax_tree, port_leaves)
from repro_torch.optim import adamw
from repro_torch.training import train_loop

ARCH = "rwkv6-3b"
GEN, PROMPT = 4, 12
TOL = 1e-5
STATES = ("x_tm", "wkv", "x_cm")
SERVE = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4", "--prompt-len", "8",
         "--gen", "4"]
TRAIN = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
         "--seq", "16", "--log-every", "1"]
#: one AdamW step of launch/train.py's schedule for 3 steps
ADAMW = dict(lr=3e-4, warmup_steps=5, total_steps=3)


@pytest.fixture(autouse=True, scope="module")
def _share_the_host():
    # pytest-xdist runs test files side by side, one a core or so: torch's
    # pool on every core then spends its time waiting on the others
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _tokens(cfg):
    return np.random.RandomState(3).randint(0, cfg.vocab, (4, PROMPT)).astype(np.int32)


def _serving(cfg, run, model, toks):
    """Greedy serving of all rows and of the first: tokens, logits, the
    decode states gathered whole and the shapes of this rank's."""
    out = {}
    for key, rows in (("all", toks), ("one", toks[:1])):
        r = serve.generate(cfg, run, model, torch.from_numpy(rows), GEN, keep_logits=True)
        brun = T.batch_run(run, rows.shape[0])
        cache = {k: r["cache"][k] for k in STATES}
        if run.mesh is not None:
            data = tuple(a for a in brun.data_axes if a in run.mesh.shape) \
                if brun.split_batch else ()
            if data:
                cache = dict(zip(STATES, C.gather_packed([cache[k] for k in STATES],
                                                         [1] * 3, data)))
            heads = T.rwkv_tp(cfg, run).axes
            if heads:
                cache["wkv"] = C.all_gather(cache["wkv"], heads, dim=2)
        out[key] = {"tokens": r["tokens"].numpy(),
                    "logits": [x.numpy() for x in r["logits"]],
                    "states": {k: v.numpy() for k, v in cache.items()},
                    "shapes": {k: tuple(r["cache"][k].shape) for k in STATES}}
    return out


def _bf16_logits(cfg, run, model):
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    r = serve.generate(cfg16, run, model, torch.from_numpy(_tokens(cfg)), GEN,
                       keep_logits=True)
    return [x.float().numpy() for x in r["logits"]]


def _rows_in_halves(x, w, axes):
    """``row_parallel`` as the two ranks of ``model`` compute it, on one
    device: two halves of ``w``'s rows, each rounded to x's dtype, summed
    in rank order."""
    n = w.shape[0] // 2
    return x[..., :n].contiguous() @ w[:n] + x[..., n:].contiguous() @ w[n:]


def _train_step(cfg, run, model, toks):
    """One AdamW step of the global batch ``toks``: the loss, the gradients
    and the updated params, whole (gathered on a mesh), and this rank's
    shards of the leaves whole over ``model``."""
    model.requires_grad_(True)
    loss = T.lm_loss(cfg, run, model, {"tokens": T.local_rows(toks, run)})
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    model.requires_grad_(False)
    tc = train_loop.TrainCfg(adamw=adamw.AdamWConfig(**ADAMW))
    state = adamw.init(tc.adamw, dict(model.named_parameters()))
    train_loop.make_train_step(cfg, run, tc)(model, state, {"tokens": toks})
    params = {n: p.detach() for n, p in model.named_parameters()}
    out = {"loss": float(loss.detach())}
    if run.mesh is None:
        return dict(out, grads={n: g.numpy() for n, g in grads.items()},
                    params={n: p.numpy() for n, p in params.items()})
    specs = T.param_specs(cfg, run.mesh)
    whole = [n for n in names if "model" not in SH.spec_axes(specs[n])]
    return dict(out, grads={n: g.numpy() for n, g in C.gather_full(grads, specs).items()},
                params={n: p.numpy() for n, p in C.gather_full(params, specs).items()},
                local_grads={n: grads[n].numpy() for n in whole},
                local_params={n: params[n].numpy() for n in whole})


def _ranks(ctx, tree):
    M.share_host(ctx)
    cfg = get_config(ARCH, smoke=True)
    run = T.RunCfg(mesh=M.mesh_of(ctx), remat=False)
    model = params_from_jax_sharded(cfg, tree, run.mesh, device="cpu")
    out = {"serve": _serving(cfg, run, model, _tokens(cfg)),
           "bf16": _bf16_logits(cfg, run, model),
           "tp": T.rwkv_tp(cfg, run),
           "Wr": tuple(model.blocks[0].tm.Wr.shape), "u": tuple(model.blocks[0].tm.u.shape),
           "main": serve.serve(serve.parse_args(SERVE + ["--mesh", "2x2"]), ctx)}
    out["train"] = _train_step(cfg, run, model, torch.from_numpy(_tokens(cfg)))
    out["train_main"] = train.train(train.parse_args(TRAIN + ["--mesh", "2x2"]), ctx)
    return out


def _jax_side(tree, toks):
    """JAX on one device with the params ``tree``: greedy serving of all
    rows and of the first, with the final decode states."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models.transformer import RunCfg as JaxRun
    from repro.models.transformer import decode_step as jax_decode
    from repro.models.transformer import prefill as jax_prefill

    jcfg, run = jax_config(ARCH, smoke=True), JaxRun(mesh=None, remat=False)
    jp = jax.tree.map(jnp.asarray, tree)
    prefill = jax.jit(lambda p, t: jax_prefill(jcfg, run, p, {"tokens": t}))
    decode = jax.jit(lambda p, c, t: jax_decode(jcfg, run, p, c, t))
    served = {}
    for key, rows in (("all", toks), ("one", toks[:1])):
        logits, cache = prefill(jp, jnp.asarray(rows))
        kept, out = [np.asarray(logits)], []
        for i in range(GEN):
            tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
            out.append(np.asarray(tok))
            if i < GEN - 1:
                logits, cache = decode(jp, cache, tok)
                kept.append(np.asarray(logits))
        served[key] = {"tokens": np.concatenate(out, 1), "logits": kept,
                       "states": {k: np.asarray(cache[k]) for k in STATES}}
    return served


def _jax_train_step(tree, toks):
    """JAX on one device: the loss and gradients of ``toks`` and the params
    after one step of the reference's train step (for one microbatch its
    ``value_and_grad`` of ``lm_loss``, then ``adamw.update``), as the
    port's names."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models.transformer import RunCfg as JaxRun
    from repro.models.transformer import lm_loss as jax_lm_loss
    from repro.optim import adamw as jax_adamw

    jcfg, run = jax_config(ARCH, smoke=True), JaxRun(mesh=None, remat=False)
    jp = jax.tree.map(jnp.asarray, tree)
    batch = {"tokens": jnp.asarray(toks)}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_lm_loss(jcfg, run, p, batch)))(jp)
    acfg = jax_adamw.AdamWConfig(**ADAMW)
    params, _, _ = jax.jit(lambda g, s, p: jax_adamw.update(acfg, g, s, p))(
        grads, jax_adamw.init(acfg, jp), jp)
    return {"loss": float(loss), "grads": port_leaves(jax.tree.map(np.asarray, grads)),
            "params": port_leaves(jax.tree.map(np.asarray, params))}


@pytest.fixture(scope="module")
def runs():
    cfg = get_config(ARCH, smoke=True)
    toks = _tokens(cfg)
    tree = _numpy(params_to_jax_tree(dict(
        T.init_model(cfg, seed=0, device="cpu").named_parameters())))
    _vary_per_head_leaves(tree)
    model = params_from_jax(cfg, tree, device="cpu")
    jres = _jax_side(tree, toks)
    jres["train"] = _jax_train_step(tree, toks)
    one = {"serve": _serving(cfg, T.RunCfg(remat=False), model, toks),
           "main": serve.main(SERVE).numpy(),
           "bf16": _bf16_logits(cfg, T.RunCfg(remat=False), model),
           "train_main": train.main(TRAIN), "tree": tree}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RW, "row_parallel", _rows_in_halves)
        one["bf16_halves"] = _bf16_logits(cfg, T.RunCfg(remat=False), model)
    got = dist.run_ranks(_ranks, 2, 2, device="cpu", args=(tree,))
    one["train"] = _train_step(cfg, T.RunCfg(remat=False), model, torch.from_numpy(toks))
    return got, one, jres


def _vary_per_head_leaves(tree):
    """Random values for the leaves that init makes constant (``w0`` zeros,
    ``ln_w`` ones, ``ln_b`` zeros), so that a rank reading another rank's
    heads' columns of them is seen."""
    rng = np.random.RandomState(9)
    tm = tree["blocks"]["tm"]
    for name, scale, shift in (("w0", 0.5, 0.0), ("ln_w", 0.3, 1.0), ("ln_b", 0.1, 0.0)):
        tm[name] = (rng.randn(*tm[name].shape) * scale + shift).astype(np.float32)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _same_serving(got, want):
    for key in ("all", "one"):
        g, w = got[key], want[key]
        assert np.array_equal(g["tokens"], w["tokens"].astype(g["tokens"].dtype)), key
        assert len(g["logits"]) == len(w["logits"]) == GEN
        for a, b in zip(g["logits"], w["logits"]):
            assert a.shape == b.shape and _rel(a, b) <= TOL, key
        for name in STATES:
            a, b = g["states"][name], np.asarray(w["states"][name], np.float32)
            assert a.shape == b.shape and _rel(a, b) <= TOL, (key, name)


def test_one_device_matches_jax(runs):
    _, one, jres = runs
    _same_serving(one["serve"], jres)


def test_serving_on_2x2_matches_one_device_and_jax(runs):
    # 4 rows (2 a rank) and 1 row (whole on every rank), every rank the
    # global batch's tokens and logits, the states gathered whole
    got, one, jres = runs
    for r in got:
        _same_serving(r["serve"], one["serve"])
        _same_serving(r["serve"], jres)


def test_each_rank_computes_its_heads_and_holds_their_state(runs):
    got, _, _ = runs
    cfg = get_config(ARCH, smoke=True)
    hs = cfg.d_model // cfg.n_heads
    for rank, r in enumerate(got):
        first = (rank % 2) * (cfg.n_heads // 2)  # model coordinate: rank % 2
        assert r["tp"].axes == ("model",) and r["tp"].heads == (first, cfg.n_heads // 2)
        assert r["tp"].mlp_axes == r["tp"].out_axes == ("model",)
        assert r["Wr"] == (cfg.d_model // 2, cfg.d_model // 2)  # FSDP x heads
        assert r["u"] == (cfg.d_model // 2,)  # embed: FSDP only, whole over model
        for key, rows in (("all", 2), ("one", 1)):
            assert r["serve"][key]["shapes"] == {
                "x_tm": (cfg.n_layers, rows, cfg.d_model),
                "wkv": (cfg.n_layers, rows, cfg.n_heads // 2, hs, hs),
                "x_cm": (cfg.n_layers, rows, cfg.d_model)}


def test_launcher_on_2x2_gives_one_devices_tokens(runs):
    got, one, _ = runs
    for r in got:
        assert np.array_equal(r["main"], one["main"])


def test_bf16_on_2x2_is_one_device_with_its_row_parallel_sums_in_halves(runs):
    # the 2x2 ranks' only other arithmetic: each row-parallel product in
    # two bf16 partial sums; one device computing them so gives their bits
    got, one, _ = runs
    for r in got:
        for a, b, c in zip(r["bf16"], one["bf16_halves"], one["bf16"]):
            assert np.array_equal(a, b)
            assert _rel(a, c) <= 3e-2


def _first_step_f64(grads, before):
    """The params after AdamW's first step from ``grads`` (every leaf),
    in f64: clipped by the global norm, m / sqrt(v) = g / |g| up to eps,
    weight decay, the schedule's lr at count 1."""
    c = adamw.AdamWConfig(**ADAMW)
    g = {n: x.astype(np.float64) for n, x in grads.items()}
    gnorm = np.sqrt(sum(float((x * x).sum()) for x in g.values()))
    scale = min(1.0, c.clip_norm / max(gnorm, 1e-9))
    lr = float(adamw.schedule(c, 1))
    out = {}
    for n, x in g.items():
        p = before[n].astype(np.float64)
        gs = x * scale
        out[n] = p - lr * (gs / (np.abs(gs) + c.eps) + c.weight_decay * p)
    return out


def _params_close(got, want, grad, mine):
    """The params after a step within TOL of their max: against ``want``
    where the gradient is far above AdamW's eps (1e-8); elsewhere the first
    step, g / (|g| + eps) times lr, hinges on the gradient's last bits (|g|
    ~ 1e-8 in the decay's LoRA), so there against ``mine``, the f64 step
    from this rank's own gradient (:func:`_first_step_f64`)."""
    tol = TOL * np.abs(want).max()
    well = np.abs(grad) > 1e-6
    assert not well.any() or np.abs(got - want)[well].max() <= tol
    assert well.all() or np.abs(got - mine)[~well].max() <= tol


def test_training_step_on_2x2_matches_one_device_and_jax(runs):
    # the loss, the gradients and the params after one AdamW step, every
    # rank's gathered whole
    got, one, jres = runs
    before = port_leaves(one["tree"])
    for want in (one["train"], jres["train"]):
        for r in got:
            t = r["train"]
            assert abs(t["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
            assert set(t["grads"]) == set(want["grads"]) == set(t["params"])
            mine = _first_step_f64(t["grads"], before)
            for name in t["grads"]:
                assert _rel(t["grads"][name], want["grads"][name]) <= TOL, name
                _params_close(t["params"][name], want["params"][name],
                              want["grads"][name], mine[name])


def test_leaves_whole_over_model_stay_equal_on_its_ranks(runs):
    # ranks 2m and 2m + 1 differ in their model coordinate only: each leaf
    # whole over model has the same gradient and update there, bit for bit
    got, _, _ = runs
    names = set(got[0]["train"]["local_params"])
    assert {"blocks.0.tm.w0", "blocks.0.tm.wA", "blocks.0.tm.wB", "blocks.0.tm.u",
            "blocks.0.tm.ln_w", "blocks.0.tm.ln_b", "blocks.0.cm.mu"} <= names
    for a, b in ((got[0], got[1]), (got[2], got[3])):
        for key in ("local_grads", "local_params"):
            for name in names:
                assert np.array_equal(a["train"][key][name], b["train"][key][name]), \
                    (key, name)


def test_train_launcher_on_2x2_gives_one_devices_losses(runs):
    got, one, _ = runs
    assert len(one["train_main"]) == 2
    for r in got:
        assert np.allclose(r["train_main"], one["train_main"], rtol=0, atol=1e-5)
