"""The port's RWKV-6 and rwkv6-3b on one device against the JAX package,
on the CPU (f32, 1e-5 relative: the same arithmetic summed in another
order).

``repro_torch.models.rwkv`` against ``repro.models.rwkv`` at rwkv6-3b's
SMOKE widths (d 64, 4 heads of 16, d_ff 128), the JAX params and the
inputs made from seeds and carried across as numpy arrays:

* the time mix's step and sequence (S=7, B=2, a nonzero shift buffer and
  WKV state), the channel mix's sequence and step, the group norm, and
  ``wkv6_plain`` at S=1 against the reference's step;
* the SMOKE config through the whole model (``params_from_jax``): names,
  shapes and logical axes, the reference's specs on 2x2, the forward's
  logits, prefill then 4 greedy decode steps against the reference's
  ``prefill``/``decode_step`` (states and logits), a decode from
  ``init_cache``'s zeros, the cache's entries, shapes and dtypes, and bf16
  compute within 3e-2·max|logit|;
* the prefill in chunks of the time axis equal to one pass; ``wkv6``'s
  refusal of other head sizes, and its gradients under autograd; the
  launchers (serving and training run; ``tests/test_torch_rwkv_train.py``
  holds the training to the JAX package).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config
from repro.distributed import sharding as jax_sharding
from repro.models import rwkv as JRW
from repro.models.common import Initializer as JaxInit
from repro.models.transformer import RunCfg as JaxRun
from repro.models.transformer import decode_step as jax_decode
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_cache as jax_init_cache
from repro.models.transformer import init_model as jax_init
from repro.models.transformer import model_axes as jax_model_axes
from repro.models.transformer import prefill as jax_prefill
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import wkv
from repro_torch.launch import serve, train
from repro_torch.models import rwkv as RW
from repro_torch.models import transformer as T
from repro_torch.models.convert import axes_to_jax_tree, params_from_jax, params_to_jax_tree

ARCH = "rwkv6-3b"
JRUN = JaxRun(mesh=None, remat=False)
TOL = 1e-5
BF16_TOL = 3e-2
B, S, GEN = 2, 12, 4


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


def _to_torch(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _dims():
    cfg = get_config(ARCH, smoke=True)
    kw = dict(d_model=cfg.d_model, n_heads=cfg.n_heads, d_ff=cfg.d_ff)
    return JRW.RWKVDims(**kw), RW.RWKVDims(**kw)


def _layer(seed=0):
    """The reference's time-mix and channel-mix params, with w0 and ln_b
    made nonzero so that every term counts."""
    jd, d = _dims()
    ini = JaxInit(key=jax.random.PRNGKey(seed), dtype=jnp.float32)
    tm = JRW.init_rwkv_time_mix(ini.sub("tm"), jd)
    cmix = JRW.init_rwkv_channel_mix(ini.sub("cm"), jd)
    rng = np.random.RandomState(seed + 10)
    tm = dict(tm, w0=jnp.asarray(rng.randn(jd.d_model).astype(np.float32) * 0.5),
              ln_b=jnp.asarray(rng.randn(jd.d_model).astype(np.float32) * 0.1))
    return jd, d, tm, cmix


def _inputs(b, s, seed=1):
    jd, _ = _dims()
    rng = np.random.RandomState(seed)
    hs = jd.head_size
    return (rng.randn(b, s, jd.d_model).astype(np.float32),
            rng.randn(b, jd.d_model).astype(np.float32),
            (rng.randn(b, jd.n_heads, hs, hs) * 0.3).astype(np.float32))


# --------------------------------------------------------------------------
# the layers
# --------------------------------------------------------------------------


def test_time_mix_seq_matches_jax():
    jd, d, tm, _ = _layer()
    x, x0, st0 = _inputs(B, 7)
    jy, (jx, js) = jax.jit(lambda p, a, b_, c: JRW.rwkv_time_mix_seq(p, jd, a, b_, c))(
        tm, jnp.asarray(x), jnp.asarray(x0), jnp.asarray(st0))
    plain = wkv.plain_calls
    y, (xl, st) = RW.time_mix_seq(_to_torch(tm), d, torch.from_numpy(x),
                                  torch.from_numpy(x0), torch.from_numpy(st0))
    assert wkv.plain_calls == plain + 1  # one call of the recurrence for all 7 steps
    assert y.shape == (B, 7, jd.d_model) and st.shape == st0.shape
    assert _rel(y.numpy(), jy) <= TOL and _rel(st.numpy(), js) <= TOL
    assert np.array_equal(xl.numpy(), np.asarray(jx))


def test_time_mix_step_matches_jax():
    jd, d, tm, _ = _layer(seed=2)
    x, x0, st0 = _inputs(B, 1, seed=3)
    jy, js = jax.jit(lambda p, a, b_, c: JRW.rwkv_time_mix_step(p, jd, a, b_, c))(
        tm, jnp.asarray(x[:, 0]), jnp.asarray(x0), jnp.asarray(st0))
    y, st = RW.time_mix_step(_to_torch(tm), d, torch.from_numpy(x[:, 0]),
                             torch.from_numpy(x0), torch.from_numpy(st0))
    assert y.shape == (B, jd.d_model)
    assert _rel(y.numpy(), jy) <= TOL and _rel(st.numpy(), js) <= TOL


@pytest.mark.parametrize("form", ["seq", "step"])
def test_channel_mix_matches_jax(form):
    jd, d, _, cmix = _layer(seed=4)
    x, x0, _ = _inputs(B, 7, seed=5)
    pt = _to_torch(cmix)
    if form == "seq":
        jy, jx = JRW.rwkv_channel_mix_seq(cmix, jnp.asarray(x), jnp.asarray(x0))
        y, xl = RW.channel_mix_seq(pt, torch.from_numpy(x), torch.from_numpy(x0))
    else:
        jy, jx = JRW.rwkv_channel_mix_step(cmix, jnp.asarray(x[:, 0]), jnp.asarray(x0))
        y, xl = RW.channel_mix_step(pt, torch.from_numpy(x[:, 0]), torch.from_numpy(x0))
    assert _rel(y.numpy(), jy) <= TOL
    assert np.array_equal(xl.numpy(), np.asarray(jx))


def test_group_norm_matches_jax():
    jd, d, tm, _ = _layer(seed=6)
    x = np.random.RandomState(7).randn(3, 5, jd.d_model).astype(np.float32) * 4 + 1
    want = JRW._group_norm(jnp.asarray(x), tm["ln_w"], tm["ln_b"], jd.n_heads)
    got = RW.group_norm(torch.from_numpy(x), torch.tensor(np.asarray(tm["ln_w"])),
                        torch.tensor(np.asarray(tm["ln_b"])), d.n_heads)
    assert got.dtype == torch.float32 and _rel(got.numpy(), want) <= TOL
    assert RW.GN_EPS == 64e-5


def test_wkv6_plain_at_one_step_is_the_references_step():
    # the recurrence of rwkv_time_mix_step (rwkv.py:78–84), the reference's
    # einsum, against wkv6_plain at S = 1
    jd, _ = _dims()
    h, k = jd.n_heads, jd.head_size
    rng = np.random.RandomState(8)
    r, kk, v = (rng.randn(B, h, k).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.randn(B, h, k))).astype(np.float32)
    u = rng.randn(h, k).astype(np.float32)
    st = rng.randn(B, h, k, k).astype(np.float32)
    kv = kk[..., :, None] * v[..., None, :]
    want_y = jnp.einsum("bhk,bhkv->bhv", r, st + u[None, :, :, None] * kv)
    want_s = w[..., :, None] * st + kv
    y, s = wkv.wkv6(*(torch.from_numpy(a[:, None].copy()) for a in (r, kk, v, w)),
                    torch.from_numpy(u), torch.from_numpy(st))
    assert _rel(y[:, 0].numpy(), want_y) <= TOL and _rel(s.numpy(), want_s) <= TOL


def test_wkv6_refuses_other_head_sizes_and_autograd():
    # other head sizes are refused; under autograd the gradients reach
    # every input, through the backward's plain version on the CPU
    r = torch.zeros(1, 2, 3, 32)
    w = torch.zeros_like(r)
    with pytest.raises(ValueError, match="head size 32"):
        wkv.wkv6(r, r, r, w, torch.zeros(3, 32), torch.zeros(1, 3, 32, 32))
    gen = torch.Generator().manual_seed(3)
    ins = [torch.randn(1, 2, 3, 16, generator=gen) for _ in range(4)] + \
        [torch.randn(3, 16, generator=gen), torch.randn(1, 3, 16, 16, generator=gen)]
    ins = [x.requires_grad_() for x in ins]
    calls = wkv.plain_bwd_calls
    y, st = wkv.wkv6(*ins)
    (y.sum() + st.sum()).backward()
    assert wkv.plain_bwd_calls == calls + 1
    assert all(x.grad is not None and bool(x.grad.abs().max() > 0) for x in ins)


# --------------------------------------------------------------------------
# rwkv6-3b's SMOKE config through the whole model
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jp, _ = jax_init(jcfg, jax.random.PRNGKey(0))
    # init makes w0, ln_w and ln_b constant: random values, so that each counts
    rng = np.random.RandomState(11)
    tm = dict(jp["blocks"]["tm"])
    for name, scale, shift in (("w0", 0.5, 0.0), ("ln_w", 0.3, 1.0), ("ln_b", 0.1, 0.0)):
        tm[name] = jnp.asarray(rng.randn(*tm[name].shape) * scale + shift, jnp.float32)
    jp = dict(jp, blocks=dict(jp["blocks"], tm=tm))
    model = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (B, S)).astype(np.int32)
    return jcfg, cfg, jp, model, toks


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_smoke_init_names_shapes_and_axes_match_jax(smoke):
    jcfg, cfg, jp, model, _ = smoke
    want = {n: tuple(np.shape(v)) for n, v in _flat(jp)}
    got = dict(_flat(params_to_jax_tree(dict(model.named_parameters()))))
    assert {n: tuple(t.shape) for n, t in got.items()} == want
    assert want["blocks.tm.u"] == (cfg.n_layers, cfg.d_model)  # (d,), cut to (H, K) at use
    assert "ln0.w" in want and len(model.first_blocks) == 0
    assert axes_to_jax_tree(T.model_axes(cfg)) == jax_model_axes(jcfg)


def test_full_config_specs_on_2x2_match_jax():
    # heads_x and embed_out over model, embed over data (FSDP), the decay's
    # and the group norm's (d,) leaves over data only
    jcfg, cfg = jax_config(ARCH), get_config(ARCH)
    mesh = {"data": 2, "model": 2}
    shapes = jax.eval_shape(lambda k: jax_init(jcfg, k)[0], jax.random.PRNGKey(0))
    stand_in = type("Mesh", (), {"shape": mesh, "axis_names": tuple(mesh)})()
    want = jax_sharding.tree_specs(stand_in, jax_model_axes(jcfg), shapes)
    specs = T.param_specs(cfg, mesh)
    for name, spec in _flat(jax.tree.map(tuple, want, is_leaf=lambda s: hasattr(s, "index"))):
        if name.startswith("blocks."):
            assert specs[f"blocks.0.{name.split('.', 1)[1]}"] == spec[1:], name
        else:
            assert specs[name] == spec, name
    assert specs["blocks.0.tm.Wr"] == ("data", "model")
    assert specs["blocks.0.tm.u"] == ("data",) and specs["blocks.0.cm.Wr"] == ("data", "model")
    run = T.RunCfg(mesh=SH.Mesh(shape=mesh, coords={"data": 0, "model": 1}))
    tp = T.rwkv_tp(cfg, run)
    assert tp == RW.RWKVTP(axes=("model",), heads=(20, 20), mlp_axes=("model",),
                           out_axes=("model",))


def test_smoke_forward_matches_jax(smoke):
    jcfg, cfg, jp, model, toks = smoke
    want, _ = jax.jit(lambda p, t: jax_forward(jcfg, JRUN, p, {"tokens": t}))(
        jp, jnp.asarray(toks))
    plain = wkv.plain_calls
    got, _ = T.forward(cfg, T.RunCfg(), model, {"tokens": torch.from_numpy(toks)})
    assert wkv.plain_calls == plain + cfg.n_layers  # one recurrence a layer
    assert got.shape == (B, S, cfg.vocab) and _rel(got.numpy(), want) <= TOL


def _states_close(got, want):
    for key in ("x_tm", "wkv", "x_cm"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert _rel(got[key].float().numpy(), np.asarray(want[key], np.float32)) <= TOL, key


def test_smoke_prefill_and_greedy_decode_match_jax(smoke):
    jcfg, cfg, jp, model, toks = smoke
    run = T.RunCfg()
    decode = jax.jit(lambda p, c, t: jax_decode(jcfg, JRUN, p, c, t))
    jl, jc = jax.jit(lambda p, t: jax_prefill(jcfg, JRUN, p, {"tokens": t},
                                              t_max=S + GEN))(jp, jnp.asarray(toks))
    plain = wkv.plain_calls
    pl, pc = T.prefill(cfg, run, model, {"tokens": torch.from_numpy(toks)}, t_max=S + GEN)
    assert wkv.plain_calls == plain + cfg.n_layers
    assert pl.shape == (B, 1, cfg.vocab) and pc["len"] == int(jc["len"]) == S
    _states_close(pc, jc)
    for _ in range(GEN):
        assert _rel(pl.numpy(), jl) <= TOL
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        pt = pl[:, -1].argmax(-1)[:, None]
        assert np.array_equal(np.asarray(jt), pt.numpy())
        plain = wkv.plain_calls
        jl, jc = decode(jp, jc, jt)
        pl, pc = T.decode_step(cfg, run, model, pc, pt)
        assert wkv.plain_calls == plain + cfg.n_layers  # S = 1, one a layer
    assert _rel(pl.numpy(), jl) <= TOL and pc["len"] == int(jc["len"]) == S + GEN
    _states_close(pc, jc)


def test_decode_from_init_cache_zeros_matches_jax(smoke):
    jcfg, cfg, jp, model, toks = smoke
    jc = jax_init_cache(jcfg, B, 8)
    pc = T.init_cache(cfg, B, 8, device="cpu")
    assert set(pc) == set(jc)
    for key in ("x_tm", "wkv", "x_cm"):
        assert tuple(pc[key].shape) == tuple(jc[key].shape), key
        assert str(pc[key].dtype).split(".")[-1] == str(jc[key].dtype), key
        assert not pc[key].any()
    tok = toks[:, :1]
    jl, jc = jax.jit(lambda p, c, t: jax_decode(jcfg, JRUN, p, c, t))(
        jp, jc, jnp.asarray(tok))
    pl, pc = T.decode_step(cfg, T.RunCfg(), model, pc, torch.from_numpy(tok))
    assert _rel(pl.numpy(), jl) <= TOL and pc["len"] == int(jc["len"]) == 1
    _states_close(pc, jc)


def test_cache_entries_shapes_and_dtypes_match_init_cache():
    for smoke_cfg in (True, False):
        jcfg, cfg = jax_config(ARCH, smoke=smoke_cfg), get_config(ARCH, smoke=smoke_cfg)
        want = jax.eval_shape(lambda: jax_init_cache(jcfg, 8, 2080))
        shapes, dtypes = T.cache_shapes(cfg, 8, 2080), T.cache_dtypes(cfg)
        assert set(shapes) | {"len"} == set(want)
        for key, shape in shapes.items():
            assert shape == tuple(want[key].shape), key
            assert str(dtypes[key]).split(".")[-1] == str(want[key].dtype), key
    # rwkv6-3b at B = 8: the whole decode state at any length
    total = sum(np.prod(s) * torch.empty(0, dtype=dtypes[k]).element_size()
                for k, s in T.cache_shapes(cfg, 8, 0).items())
    assert total == 170_393_600


def test_bf16_compute_within_3e_2_of_max_logit(smoke):
    jcfg, cfg, jp, model, toks = smoke
    jb = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    pb = dataclasses.replace(cfg, compute_dtype="bfloat16")
    want, _ = jax.jit(lambda p, t: jax_forward(jb, JRUN, p, {"tokens": t}))(
        jp, jnp.asarray(toks))
    got, cache = T.forward(pb, T.RunCfg(), model, {"tokens": torch.from_numpy(toks)},
                           collect_cache=True)
    assert got.dtype == torch.bfloat16 and cache["wkv"].dtype == torch.float32
    assert cache["x_tm"].dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert _rel(got.float().numpy(), want) <= BF16_TOL


def test_prefill_in_chunks_of_the_time_axis_is_one_pass(smoke, monkeypatch):
    _, cfg, _, model, toks = smoke
    run = T.RunCfg()
    whole, wc = T.prefill(cfg, run, model, {"tokens": torch.from_numpy(toks)})
    monkeypatch.setattr(T, "SEQ_CHUNK_TOKENS", 2 * 5)  # 5 positions a chunk at B = 2
    plain = wkv.plain_calls
    cut, cc = T.prefill(cfg, run, model, {"tokens": torch.from_numpy(toks)})
    assert wkv.plain_calls == plain + cfg.n_layers * 3  # chunks of 5, 5, 2
    assert _rel(cut.numpy(), whole.numpy()) <= TOL
    for key in ("x_tm", "wkv", "x_cm"):
        assert _rel(cc[key].numpy(), wc[key].numpy()) <= TOL, key


def test_launchers_serve_rwkv_and_refuse_its_training(capsys):
    # both launchers run rwkv6-3b (its training was refused until the
    # kernel's backward was ported)
    toks = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen", "3"])
    assert toks.shape == (2, 3)
    assert "prefill 8 tokens x2" in capsys.readouterr().out
    cfg = get_config(ARCH, smoke=True)
    model = T.init_model(cfg, seed=0, device="cpu")
    loss = T.lm_loss(cfg, T.RunCfg(), model, {"tokens": torch.zeros(2, 4, dtype=torch.long)})
    assert bool(torch.isfinite(loss))
    losses = train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1",
                         "--batch", "2", "--seq", "16"])
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert "[done]" in capsys.readouterr().out
