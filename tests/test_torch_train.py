"""The port's training slice against the JAX package, on the CPU, at
smollm-360m's SMOKE config (2 layers, d 60, f32).

The same numpy-seeded inputs go through both packages: the data pipeline
(bitwise, every kind, 2 shards), AdamW's schedule (≤ 1e-7 relative) and one
update (≤ 1e-6 relative in f32; bf16 moments within one bf16 unit in the
last place), ``lm_loss`` and its gradients with JAX's params carried over
(loss ≤ 1e-5 relative, each gradient leaf ≤ 1e-4·max|g|), and a 6-step
trajectory of the train step at 1 and 2 microbatches (losses within 1e-4,
final params ≤ 1e-4·max|p|).  Remat changes no bit of the loss or the
gradients.  ``flash_attention`` on CUDA tensors under autograd is held
with its launch stubbed: its output is attached to q, k and v and its
backward gives the direct attention's gradients.
"""

import ctypes
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config
from repro.data import pipeline as jax_pipe
from repro.models import init_model as jax_init
from repro.models.transformer import RunCfg as JaxRun
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim import adamw as jax_adamw
from repro.training import train_loop as jax_train
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.kernels import attention as A
from repro_torch.launch.train import train_tree
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, params_to_jax_tree, port_leaves
from repro_torch.optim import adamw
from repro_torch.training import train_loop

ARCH = "smollm-360m"
JRUN = JaxRun(mesh=None, remat=False)
B, S = 4, 32


def _setup(seed=0):
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jp, _ = jax_init(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, model


def _tokens(cfg, seed=0, b=B, s=S):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, s)).astype(np.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


# --------------------------------------------------------------------------
# data pipeline
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["tokens", "embeds", "frames", "token_file"])
@pytest.mark.parametrize("shard", [0, 1])
def test_pipeline_is_bitwise_the_reference(tmp_path, kind, shard):
    kw = dict(vocab=97, seq_len=16, global_batch=4, seed=7, d_model=12)
    if kind == "token_file":
        path = str(tmp_path / "tokens.bin")
        pipeline.write_token_file(
            path, np.random.RandomState(3).randint(0, 1 << 20, 4096))
        kw.update(kind="tokens", token_file=path)
    else:
        kw.update(kind=kind)
    got = pipeline.Pipeline(pipeline.DataConfig(**kw), shard=shard, num_shards=2)
    want = jax_pipe.Pipeline(jax_pipe.DataConfig(**kw), shard=shard, num_shards=2)
    for step in (0, 1, 5, 1000):
        a, b = got.batch_for_step(step), want.batch_for_step(step)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
            assert a[key].tobytes() == b[key].tobytes(), (kind, step, key)


def test_make_pipeline_takes_one_shard_without_a_process_group():
    cfg = pipeline.DataConfig(vocab=11, seq_len=4, global_batch=2)
    pipe = pipeline.make_pipeline(cfg)
    assert (pipe.shard, pipe.num_shards, pipe.local_batch) == (0, 1, 2)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

ACFG = dict(lr=3e-4, warmup_steps=5, total_steps=40, weight_decay=0.1)


@pytest.mark.parametrize("step", [0, 1, 5, 22, 40])
def test_schedule_matches_jax(step):
    got = adamw.schedule(adamw.AdamWConfig(**ACFG), step)
    want = jax_adamw.schedule(jax_adamw.AdamWConfig(**ACFG), step)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-7 * abs(float(want))


def _random_tree(rng):
    return {"embed": rng.randn(13, 6).astype(np.float32),
            "final_norm": {"w": rng.randn(6).astype(np.float32)},
            "blocks": {"attn": {"wq": rng.randn(2, 6, 3, 4).astype(np.float32)},
                       "ln1": {"w": rng.randn(2, 6).astype(np.float32)}}}


def _flat(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in port_leaves(tree).items()}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_update_matches_jax(moment_dtype):
    rng = np.random.RandomState(0)
    params, grads, m, v = (_random_tree(rng) for _ in range(4))
    v = jax.tree.map(np.abs, v)
    kw = dict(ACFG, moment_dtype=moment_dtype, clip_norm=0.5)
    jc, c = jax_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    mdt = jnp.dtype(moment_dtype)
    jstate = {"m": jax.tree.map(lambda a: jnp.asarray(a, mdt), m),
              "v": jax.tree.map(lambda a: jnp.asarray(a, mdt), v),
              "count": jnp.asarray(3, jnp.int32)}
    jp, js, jm = jax_adamw.update(jc, jax.tree.map(jnp.asarray, grads), jstate,
                                  jax.tree.map(jnp.asarray, params))
    tdt = getattr(torch, moment_dtype)
    state = {"m": {k: x.to(tdt) for k, x in _flat(m).items()},
             "v": {k: x.to(tdt) for k, x in _flat(v).items()},
             "count": torch.tensor(3, dtype=torch.int32)}
    ps = _flat(params)
    p_ids = {k: id(x) for k, x in ps.items()}
    got_p, got_s, got_m = adamw.update(c, _flat(grads), state, ps)
    assert {k: id(x) for k, x in got_p.items()} == p_ids      # in place
    assert int(got_s["count"]) == 4 and got_s["count"].dtype == torch.int32
    assert abs(float(got_m["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-6 * float(jm["grad_norm"])
    assert abs(float(got_m["lr"]) - float(jm["lr"])) <= 1e-7 * float(jm["lr"])
    for name, want in port_leaves(jax.tree.map(np.asarray, jp)).items():
        assert _rel(got_p[name], want) <= 1e-6, name
    for key in ("m", "v"):
        for name, want in port_leaves(js[key]).items():
            got = got_s[key][name]
            assert got.dtype == tdt
            want = np.asarray(want, np.float32)
            if moment_dtype == "float32":
                assert _rel(got, want) <= 1e-6, (key, name)
            else:  # one bf16 unit in the last place of the reference's
                ulp = np.where(want == 0, 0.0,
                               np.exp2(np.floor(np.log2(np.abs(want) + 1e-45)) - 7))
                assert np.all(np.abs(got.float().numpy() - want) <= ulp), (key, name)


# --------------------------------------------------------------------------
# the loss, its gradients, remat
# --------------------------------------------------------------------------


def test_lm_loss_and_gradients_match_jax():
    jcfg, cfg, jp, model = _setup()
    toks = _tokens(cfg)
    want, jg = jax.value_and_grad(
        lambda p: jax_lm_loss(jcfg, JRUN, p, {"tokens": jnp.asarray(toks)}))(jp)
    model.requires_grad_(True)
    loss = T.lm_loss(cfg, T.RunCfg(), model, {"tokens": torch.from_numpy(toks)})
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    jleaves = port_leaves(jax.tree.map(np.asarray, jg))
    assert set(jleaves) == set(grads)
    for name, g in grads.items():
        assert g.dtype == torch.float32
        assert _rel(g, jleaves[name]) <= 1e-4, name


def _loss_and_grads(cfg, run, model, toks):
    model.requires_grad_(True)
    loss = T.lm_loss(cfg, run, model, {"tokens": toks})
    return loss, torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("n_layers", [2, 16])
def test_remat_changes_no_bit(n_layers):
    # 2 layers: one checkpoint a layer; 16: two groups of 8 inside
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), remat=True,
                              n_layers=n_layers)
    model = T.init_model(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, seed=1, b=2, s=16))
    calls = {}
    out = {}
    for remat in (False, True):
        run = T.RunCfg(remat=remat)
        before = A.plain_calls
        out[remat] = _loss_and_grads(cfg, run, model, toks)
        calls[remat] = A.plain_calls - before
        assert calls[remat] == T.block_forwards(cfg, run)
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1], out[True][1]))
    # the recompute: each layer once more, and within a group of several
    # the group's forward up to its last layer's input
    assert calls == {False: n_layers,
                     True: 2 * n_layers if n_layers <= 8 else 3 * n_layers - n_layers // 8}


def test_remat_is_off_where_the_config_or_the_run_turns_it_off():
    cfg = get_config(ARCH, smoke=True)
    assert not cfg.remat and T.block_forwards(cfg, T.RunCfg()) == cfg.n_layers
    on = dataclasses.replace(cfg, remat=True)
    assert T.block_forwards(on, T.RunCfg(remat=False)) == cfg.n_layers
    assert T.block_forwards(get_config(ARCH), T.RunCfg()) == 92  # 32 layers, groups of 8
    assert T._remat_group(32) == 8 and T._remat_group(7) == 7 and T._remat_group(11) == 1


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_six_step_trajectory_matches_jax(microbatches):
    # launch/train.py's AdamW for --steps 6: the default lr, warmup
    # max(6 // 20, 5).  An element whose gradient lies at the f32 noise
    # floor (|g| ~ 1e-8, eps's size) takes a step of a different fraction
    # of lr in each package, so the params' gap grows with lr
    jcfg, cfg, jp, model = _setup(seed=2)
    kw = dict(lr=3e-4, warmup_steps=5, total_steps=6)
    jt = jax_train.TrainCfg(microbatches=microbatches,
                            adamw=jax_adamw.AdamWConfig(**kw))
    tc = train_loop.TrainCfg(microbatches=microbatches, adamw=adamw.AdamWConfig(**kw))
    jstep = jax.jit(jax_train.make_train_step(jcfg, JRUN, jt))
    step = train_loop.make_train_step(cfg, T.RunCfg(), tc)
    jstate = jax_adamw.init(jt.adamw, jp)
    state = adamw.init(tc.adamw, dict(model.named_parameters()))
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    pipe = pipeline.Pipeline(dcfg)
    for i in range(6):
        batch = pipe.batch_for_step(i)
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(x) for k, x in batch.items()})
        loss, metrics = step(model, state, {k: torch.from_numpy(x) for k, x in batch.items()})
        assert abs(float(loss) - float(jm["loss"])) <= 1e-4, (i, float(loss), float(jm["loss"]))
        assert set(metrics) == {"grad_norm", "lr", "loss"}
        assert abs(float(metrics["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-4 * float(jm["grad_norm"])
    assert int(state["count"]) == 6
    for name, want in port_leaves(jax.tree.map(np.asarray, jp)).items():
        got = dict(model.named_parameters())[name].detach()
        assert _rel(got, want) <= 1e-4, name


def test_grad_compression_names_its_roadmap_item():
    tc = train_loop.TrainCfg(grad_compression=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        train_loop.make_train_step(get_config(ARCH, smoke=True), T.RunCfg(), tc)


# --------------------------------------------------------------------------
# checkpoint layout
# --------------------------------------------------------------------------


def test_params_to_jax_tree_inverts_params_from_jax():
    jcfg, cfg, jp, model = _setup(seed=3)
    tree = params_to_jax_tree(model.named_parameters())
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0]
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.detach().numpy(), tree))[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (_, a), (_, b) in zip(flat_t, flat_j):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_train_tree_has_the_jax_trainers_keys():
    from repro.checkpoint.checkpoint import _flatten as jax_flatten
    from repro_torch.checkpoint.checkpoint import _flatten

    jcfg, cfg, jp, model = _setup()
    acfg = jax_adamw.AdamWConfig()
    want = jax_flatten((jp, jax_adamw.init(acfg, jp)))[0]
    got = _flatten(train_tree(model, adamw.init(
        adamw.AdamWConfig(), dict(model.named_parameters()))))
    assert sorted(got) == sorted(want)
    for key, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[key].shape), key
        assert str(leaf.dtype).split(".")[-1] == str(want[key].dtype), key


# --------------------------------------------------------------------------
# flash attention under autograd (the kernel's launch stubbed)
# --------------------------------------------------------------------------


@pytest.fixture
def stub_launch(monkeypatch):
    """``flash_attention`` as on a card: the tensors are taken for CUDA
    ones and the launch writes the plain version's output where the
    kernel would."""
    state = {"launched": 0}

    def launch(who, fn, device, q_ptr, k_ptr, v_ptr, o_ptr, *args, stream=None,
               detail=""):
        q, k, v = (x.detach() for x in state["qkv"])
        want = A.flash_attention_plain(q, k, v, causal=bool(args[-3])).contiguous()
        ctypes.memmove(o_ptr, want.data_ptr(), want.numel() * want.element_size())
        state["launched"] += 1

    monkeypatch.setattr(A._launch, "runs_plain", lambda who, x: False)
    monkeypatch.setattr(A._launch, "launch", launch)
    monkeypatch.setattr(A, "_LIB", types.SimpleNamespace(fn=lambda entry: None))
    return state


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("grad_of", ["qkv", "q", "v"])
def test_flash_attention_under_autograd_reaches_q_k_v(stub_launch, causal, grad_of):
    gen = torch.Generator().manual_seed(4)
    b, s, h, hkv, d = 2, 24, 6, 2, 16
    q = torch.randn(b, s, h, d, generator=gen)
    k = torch.randn(b, s, hkv, d, generator=gen)
    v = torch.randn(b, s, hkv, d, generator=gen)
    qkv = [x.requires_grad_(name in grad_of) for name, x in zip("qkv", (q, k, v))]
    stub_launch["qkv"] = qkv
    launches, plain = A.launches, A.plain_calls
    o = A.flash_attention(*qkv, causal=causal)
    assert o.grad_fn is not None and stub_launch["launched"] == 1
    assert A.launches == launches + 1
    do = torch.randn(o.shape, generator=gen)
    plain = A.plain_calls
    o.backward(do)
    assert A.plain_calls == plain   # the backward never runs the plain version
    # the direct attention's gradients
    ref = [x.detach().clone().requires_grad_(x.requires_grad) for x in qkv]
    mask = (torch.arange(s)[None, :] <= torch.arange(s)[:, None])[None, None, None]
    dims = L.AttnDims(d_model=h * d, n_heads=h, n_kv_heads=hkv, head_dim=d)
    L._sdpa_direct(*ref, dims, mask=mask if causal else None).backward(do)
    for name, got, want in zip("qkv", qkv, ref):
        if name in grad_of:
            assert float((got.grad - want.grad).abs().max()) <= 1e-5, name
        else:
            assert got.grad is None


def test_flash_attention_without_autograd_launches_without_a_graph(stub_launch):
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(1, 8, 2, 8, generator=gen, requires_grad=True)
    k = torch.randn(1, 8, 1, 8, generator=gen)
    v = torch.randn(1, 8, 1, 8, generator=gen)
    stub_launch["qkv"] = (q, k, v)
    with torch.no_grad():
        o = A.flash_attention(q, k, v)
    assert o.grad_fn is None and stub_launch["launched"] == 1
    o = A.flash_attention(q.detach(), k, v)
    assert o.grad_fn is None and stub_launch["launched"] == 2
    want = A.flash_attention_plain(q.detach(), k, v)
    assert torch.equal(o, want)


def test_attention_grad_matches_jax():
    gen = np.random.RandomState(6)
    b, s, h, hkv, d = 2, 12, 4, 2, 8
    q, k, v, do = (gen.randn(*shape).astype(np.float32) for shape in
                   ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d)))
    from repro.models import layers as JL

    dims = JL.AttnDims(d_model=h * d, n_heads=h, n_kv_heads=hkv, head_dim=d)
    mask = (jnp.arange(s)[None, :] <= jnp.arange(s)[:, None])[None, None, None]
    _, vjp = jax.vjp(lambda a, b_, c: JL._sdpa_direct(a, b_, c, dims, mask), q, k, v)
    want = vjp(jnp.asarray(do))
    got = A.attention_grad(*(torch.from_numpy(x) for x in (q, k, v, do)), causal=True)
    for g, w in zip(got, want):
        assert float(np.max(np.abs(g.numpy() - np.asarray(w)))) <= 1e-5
