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
  halves of their rows, each rounded to bf16 and summed in rank order.
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
from repro_torch.launch import serve
from repro_torch.models import rwkv as RW
from repro_torch.models import transformer as T
from repro_torch.models.convert import (params_from_jax, params_from_jax_sharded,
                                        params_to_jax_tree)

ARCH = "rwkv6-3b"
GEN, PROMPT = 4, 12
TOL = 1e-5
STATES = ("x_tm", "wkv", "x_cm")
SERVE = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4", "--prompt-len", "8",
         "--gen", "4"]


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


def _ranks(ctx, tree):
    M.share_host(ctx)
    cfg = get_config(ARCH, smoke=True)
    run = T.RunCfg(mesh=M.mesh_of(ctx), remat=False)
    model = params_from_jax_sharded(cfg, tree, run.mesh, device="cpu")
    return {"serve": _serving(cfg, run, model, _tokens(cfg)),
            "bf16": _bf16_logits(cfg, run, model),
            "tp": T.rwkv_tp(cfg, run),
            "Wr": tuple(model.blocks[0].tm.Wr.shape), "u": tuple(model.blocks[0].tm.u.shape),
            "main": serve.serve(serve.parse_args(SERVE + ["--mesh", "2x2"]), ctx)}


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


@pytest.fixture(scope="module")
def runs():
    cfg = get_config(ARCH, smoke=True)
    toks = _tokens(cfg)
    tree = _numpy(params_to_jax_tree(dict(
        T.init_model(cfg, seed=0, device="cpu").named_parameters())))
    _vary_per_head_leaves(tree)
    model = params_from_jax(cfg, tree, device="cpu")
    jres = _jax_side(tree, toks)
    one = {"serve": _serving(cfg, T.RunCfg(remat=False), model, toks),
           "main": serve.main(SERVE).numpy(),
           "bf16": _bf16_logits(cfg, T.RunCfg(remat=False), model)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RW, "row_parallel", _rows_in_halves)
        one["bf16_halves"] = _bf16_logits(cfg, T.RunCfg(remat=False), model)
    got = dist.run_ranks(_ranks, 2, 2, device="cpu", args=(tree,))
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
