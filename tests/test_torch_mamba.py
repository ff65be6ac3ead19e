"""The port's Mamba layers and the Jamba hybrid on one device against the
JAX package, on the CPU (f32, 1e-5 relative: the same arithmetic summed
in another order).

``repro_torch.models.mamba`` against ``repro.models.mamba`` at
jamba-1.5-large's SMOKE widths (d 64, d_inner 128, d_state 8, d_conv 4),
the JAX params and the inputs made from seeds and carried across as numpy
arrays:

* ``selective_scan_plain`` at S=1 against the reference's step;
  ``mamba_seq`` (S=7) and ``mamba_step`` from nonzero conv and SSM states
  (y, the conv tail, the state); a prompt in two halves with the states
  carried against the whole;
* the SMOKE config through the whole model (``params_from_jax``): names,
  shapes and logical axes, the conversion's round trip, the forward's
  logits, prefill then 4 greedy decode steps against the reference's
  ``prefill``/``decode_step`` (logits, k, v, conv, ssm, ``len``), a
  decode from ``init_cache``'s zeros, the cache's entries, shapes and
  dtypes, and bf16 compute (a Mamba layer within 2e-2 of the reference's);
* one card's share of the experts: a MoE layer's outputs with experts
  [0, 2) and [2, 4) held sum to the reference's ``apply_moe`` of all 4, at
  capacity factors 8.0 and 1.25 (where pairs drop).
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
from repro.models import mamba as JMB
from repro.models import moe as JMOE
from repro.models.common import Initializer as JaxInit
from repro.models.transformer import RunCfg as JaxRun
from repro.models.transformer import decode_step as jax_decode
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_cache as jax_init_cache
from repro.models.transformer import init_model as jax_init
from repro.models.transformer import model_axes as jax_model_axes
from repro.models.transformer import moe_dims as jax_moe_dims
from repro.models.transformer import prefill as jax_prefill
from repro_torch.configs import get_config
from repro_torch.kernels import selective_scan as SS
from repro_torch.launch import serve
from repro_torch.models import mamba as MB
from repro_torch.models import transformer as T
from repro_torch.models.convert import axes_to_jax_tree, params_from_jax, params_to_jax_tree

ARCH = "jamba-1.5-large-398b"
JRUN = JaxRun(mesh=None, remat=False)
TOL = 1e-5
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


def _dims():
    mc = get_config(ARCH, smoke=True).mamba
    kw = dict(d_model=get_config(ARCH, smoke=True).d_model, d_state=mc.d_state,
              d_conv=mc.d_conv, expand=mc.expand)
    return JMB.MambaDims(**kw), MB.MambaDims(**kw)


def _layer(seed=0):
    """The reference's Mamba params, with conv_b, dt_b, A_log and D made
    random so that every term counts."""
    jd, d = _dims()
    p = JMB.init_mamba(JaxInit(key=jax.random.PRNGKey(seed), dtype=jnp.float32), jd)
    rng = np.random.RandomState(seed + 10)
    for name, scale, shift in (("conv_b", 0.1, 0.0), ("dt_b", 0.5, -1.0),
                               ("A_log", 0.5, 0.5), ("D", 0.5, 1.0)):
        p[name] = jnp.asarray(rng.randn(*p[name].shape) * scale + shift, jnp.float32)
    return jd, d, p, {k: torch.tensor(np.asarray(v)) for k, v in p.items()}


def _inputs(b, s, seed=1):
    jd, _ = _dims()
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, jd.d_model).astype(np.float32),
            rng.randn(b, jd.d_conv - 1, jd.d_inner).astype(np.float32),
            (rng.randn(b, jd.d_inner, jd.d_state) * 0.3).astype(np.float32))


# --------------------------------------------------------------------------
# the layers
# --------------------------------------------------------------------------


def test_selective_scan_plain_at_one_step_is_the_references_step():
    # the step of mamba_seq (mamba.py:102–106) and its D skip (:109),
    # against selective_scan at S = 1
    jd, _ = _dims()
    di, ds = jd.d_inner, jd.d_state
    rng = np.random.RandomState(8)
    dt = np.log1p(np.exp(rng.randn(B, di))).astype(np.float32)
    x, bm, cm = (rng.randn(B, n).astype(np.float32) for n in (di, ds, ds))
    a_log, h = (rng.randn(*shape).astype(np.float32) * 0.5 for shape in ((di, ds), (B, di, ds)))
    dd = rng.randn(di).astype(np.float32)
    a = -jnp.exp(a_log)
    want_h = jnp.exp(dt[..., None] * a) * h + (dt * x)[..., None] * bm[:, None, :]
    want_y = jnp.einsum("bds,bs->bd", want_h, cm) + x * dd
    plain = SS.plain_calls
    y, hh = SS.selective_scan(*(torch.from_numpy(v[:, None].copy()) for v in (dt, x, bm, cm)),
                              torch.from_numpy(a_log), torch.from_numpy(dd),
                              torch.from_numpy(h))
    assert SS.plain_calls == plain + 1 and y.shape == (B, 1, di)
    assert _rel(y[:, 0].numpy(), want_y) <= TOL and _rel(hh.numpy(), want_h) <= TOL


def test_selective_scan_refuses_other_state_sizes():
    z = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="d_state 4"):
        SS.selective_scan(z, z, z, z, torch.zeros(4, 4), torch.zeros(4), torch.zeros(1, 4, 4))
    assert SS.selective_scan_exps(8, 2048, 16384, 16) == 4_294_967_296
    assert SS.selective_scan_bytes(8, 1, 16384, 16, 2) == 19_203_072


def test_mamba_seq_matches_jax():
    jd, d, jp, pt = _layer()
    x, conv0, ssm0 = _inputs(B, 7)
    jy, (jc, js) = jax.jit(lambda p, a, b_, c: JMB.mamba_seq(p, jd, a, b_, c))(
        jp, jnp.asarray(x), jnp.asarray(conv0), jnp.asarray(ssm0))
    plain = SS.plain_calls
    y, (conv, ssm) = MB.mamba_seq(pt, d, torch.from_numpy(x), torch.from_numpy(conv0),
                                  torch.from_numpy(ssm0))
    assert SS.plain_calls == plain + 1  # one call of the recurrence for all 7 steps
    assert y.shape == (B, 7, jd.d_model) and conv.shape == conv0.shape
    assert _rel(y.numpy(), jy) <= TOL and _rel(ssm.numpy(), js) <= TOL
    assert np.array_equal(conv.numpy(), np.asarray(jc))


def test_mamba_step_matches_jax():
    jd, d, jp, pt = _layer(seed=2)
    x, conv0, ssm0 = _inputs(B, 1, seed=3)
    jy, (jc, js) = jax.jit(lambda p, a, b_, c: JMB.mamba_step(p, jd, a, b_, c))(
        jp, jnp.asarray(x[:, 0]), jnp.asarray(conv0), jnp.asarray(ssm0))
    plain = SS.plain_calls
    y, (conv, ssm) = MB.mamba_step(pt, d, torch.from_numpy(x[:, 0]), torch.from_numpy(conv0),
                                   torch.from_numpy(ssm0))
    assert SS.plain_calls == plain + 1 and y.shape == (B, jd.d_model)
    assert _rel(y.numpy(), jy) <= TOL and _rel(ssm.numpy(), js) <= TOL
    assert np.array_equal(conv.numpy(), np.asarray(jc))


def test_a_prompt_in_two_halves_with_the_states_carried_is_the_whole():
    _, d, _, pt = _layer(seed=4)
    x, conv0, ssm0 = (torch.from_numpy(a) for a in _inputs(B, 11, seed=5))
    y, (conv, ssm) = MB.mamba_seq(pt, d, x, conv0, ssm0)
    y1, (c1, s1) = MB.mamba_seq(pt, d, x[:, :6], conv0, ssm0)
    y2, (c2, s2) = MB.mamba_seq(pt, d, x[:, 6:], c1, s1)
    assert _rel(torch.cat([y1, y2], 1).numpy(), y.numpy()) <= TOL
    assert _rel(s2.numpy(), ssm.numpy()) <= TOL and torch.equal(c2, conv)


# --------------------------------------------------------------------------
# jamba's SMOKE config through the whole model
# --------------------------------------------------------------------------


def _jax_params(jcfg, seed=0):
    """The reference's params, A_log, D, dt_b and conv_b random (init makes
    them constant) so that each counts."""
    jp, _ = jax_init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(11 + seed)
    mam = dict(jp["blocks"]["mamba"])
    for name, scale, shift in (("A_log", 0.5, 0.5), ("D", 0.5, 1.0), ("dt_b", 0.5, -1.0),
                               ("conv_b", 0.1, 0.0)):
        mam[name] = jnp.asarray(rng.randn(*mam[name].shape) * scale + shift, jnp.float32)
    return dict(jp, blocks=dict(jp["blocks"], mamba=mam))


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jp = _jax_params(jcfg)
    model = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (B, S)).astype(np.int32)
    return jcfg, cfg, jp, model, toks


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_smoke_init_names_shapes_axes_and_round_trip_match_jax(smoke):
    jcfg, cfg, jp, model, _ = smoke
    want = dict(_flat(jp))
    got = dict(_flat(params_to_jax_tree(dict(model.named_parameters()))))
    assert set(got) == set(want)
    for name, leaf in got.items():
        assert np.array_equal(leaf.numpy(), np.asarray(want[name])), name
    per = cfg.hybrid_period
    assert tuple(want["blocks.ln1"].shape) == (1, per, cfg.d_model)
    assert tuple(want["blocks.mamba.A_log"].shape) == (1, per - 1, 128, 8)
    assert tuple(want["blocks.moe.experts.wi_gate"].shape) == (1, per // 2, 4, 64, 128)
    assert axes_to_jax_tree(T.model_axes(cfg)) == jax_model_axes(jcfg)
    # the port's own init: the same names and shapes
    own = T.init_model(cfg, seed=0, device="cpu")
    assert {n: tuple(p.shape) for n, p in own.named_parameters()} == \
        {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert bool((own.blocks[0].mamba.A_log == 1).all()) and not own.blocks[0].mamba.conv_b.any()


def test_smoke_forward_matches_jax(smoke):
    jcfg, cfg, jp, model, toks = smoke
    want, _ = jax.jit(lambda p, t: jax_forward(jcfg, JRUN, p, {"tokens": t}))(
        jp, jnp.asarray(toks))
    plain = SS.plain_calls
    got, _ = T.forward(cfg, T.RunCfg(), model, {"tokens": torch.from_numpy(toks)})
    assert SS.plain_calls == plain + cfg.n_layers - 1  # one recurrence a Mamba layer
    assert got.shape == (B, S, cfg.vocab) and _rel(got.numpy(), want) <= TOL


def _cache_close(got, want):
    assert set(got) == set(want)
    assert int(got["len"]) == int(want["len"])
    for key in ("k", "v", "conv", "ssm"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert _rel(got[key].float().numpy(), np.asarray(want[key], np.float32)) <= TOL, key


def test_smoke_prefill_and_greedy_decode_match_jax(smoke):
    jcfg, cfg, jp, model, toks = smoke
    run = T.RunCfg()
    decode = jax.jit(lambda p, c, t: jax_decode(jcfg, JRUN, p, c, t))
    jl, jc = jax.jit(lambda p, t: jax_prefill(jcfg, JRUN, p, {"tokens": t},
                                              t_max=S + GEN))(jp, jnp.asarray(toks))
    pl, pc = T.prefill(cfg, run, model, {"tokens": torch.from_numpy(toks)}, t_max=S + GEN)
    assert pl.shape == (B, 1, cfg.vocab) and pc["len"] == S
    _cache_close(pc, jc)
    for _ in range(GEN):
        assert _rel(pl.numpy(), jl) <= TOL
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        pt = pl[:, -1].argmax(-1)[:, None]
        assert np.array_equal(np.asarray(jt), pt.numpy())
        plain = SS.plain_calls
        jl, jc = decode(jp, jc, jt)
        pl, pc = T.decode_step(cfg, run, model, pc, pt)
        assert SS.plain_calls == plain + cfg.n_layers - 1  # S = 1, one a Mamba layer
    assert _rel(pl.numpy(), jl) <= TOL and pc["len"] == S + GEN
    _cache_close(pc, jc)


def test_decode_from_init_cache_zeros_matches_jax(smoke):
    jcfg, cfg, jp, model, toks = smoke
    jc = jax_init_cache(jcfg, B, 8)
    pc = T.init_cache(cfg, B, 8, device="cpu")
    for key in ("k", "v", "conv", "ssm"):
        assert str(pc[key].dtype).split(".")[-1] == str(jc[key].dtype), key
        assert not pc[key].any()
    jl, jc = jax.jit(lambda p, c, t: jax_decode(jcfg, JRUN, p, c, t))(
        jp, jc, jnp.asarray(toks[:, :1]))
    pl, pc = T.decode_step(cfg, T.RunCfg(), model, pc, torch.from_numpy(toks[:, :1]))
    assert _rel(pl.numpy(), jl) <= TOL
    _cache_close(pc, jc)


def test_cache_entries_shapes_and_dtypes_match_init_cache():
    for smoke_cfg in (True, False):
        jcfg, cfg = jax_config(ARCH, smoke=smoke_cfg), get_config(ARCH, smoke=smoke_cfg)
        want = jax.eval_shape(lambda: jax_init_cache(jcfg, 8, 2080))
        shapes, dtypes = T.cache_shapes(cfg, 8, 2080), T.cache_dtypes(cfg)
        assert set(shapes) | {"len"} == set(want)
        for key, shape in shapes.items():
            assert shape == tuple(want[key].shape), key
            assert str(dtypes[key]).split(".")[-1] == str(want[key].dtype), key


def test_bf16_compute_tracks_the_reference(smoke):
    # a Mamba layer in bf16 within 2e-2 of the reference's (a few bf16
    # units: each package's own bf16 layer parts from its f32 one by
    # 0.4-0.9 %); the whole model's logits and conv tail in bf16, the SSM
    # state f32.  The whole model's bf16 logits are not held to the
    # reference's: the MoE's top-2 flips under bf16 roundoff, and the
    # reference's own bf16 logits part from its f32 ones by 0.59 of max
    jd, d, jp, pt = _layer(seed=6)
    x, conv0, ssm0 = _inputs(B, 7, seed=7)
    jy, (_, js) = JMB.mamba_seq({k: v.astype(jnp.bfloat16) for k, v in jp.items()}, jd,
                                jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(conv0, jnp.bfloat16), jnp.asarray(ssm0))
    y, (conv, ssm) = MB.mamba_seq({k: v.bfloat16() for k, v in pt.items()}, d,
                                  torch.from_numpy(x).bfloat16(),
                                  torch.from_numpy(conv0).bfloat16(), torch.from_numpy(ssm0))
    assert y.dtype == conv.dtype == torch.bfloat16 and ssm.dtype == torch.float32
    assert _rel(y.float().numpy(), np.asarray(jy.astype(jnp.float32))) <= 2e-2
    assert _rel(ssm.numpy(), js) <= 2e-2
    _, cfg, _, model, toks = smoke
    pb = dataclasses.replace(cfg, compute_dtype="bfloat16")
    got, cache = T.forward(pb, T.RunCfg(), model, {"tokens": torch.from_numpy(toks)},
                           collect_cache=True)
    assert got.dtype == cache["conv"].dtype == cache["k"].dtype == torch.bfloat16
    assert cache["ssm"].dtype == torch.float32 and bool(torch.isfinite(got).all())


# --------------------------------------------------------------------------
# one card's share of the experts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_the_shares_of_the_experts_sum_to_the_whole_layer(cf):
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    jp = _jax_params(jcfg, seed=1)
    x = np.random.RandomState(3).randn(B, S, cfg.d_model).astype(np.float32)
    layer = jax.tree.map(lambda t: t[0, 1], jp["blocks"]["moe"])  # superblock 0, MoE 1
    want = JMOE.apply_moe(layer, jax_moe_dims(jcfg), jnp.asarray(x))
    got = 0
    for held in ((0, 2), (2, 2)):
        model = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu",
                                experts=held)
        assert model.blocks[0].moe.experts.wi_gate.shape[1] == 2
        p = T._sub(T._cast_f(model.blocks[0].moe, None), 1, torch.float32)
        got = got + T._ff_apply(p, cfg, T.RunCfg(), torch.from_numpy(x), held[0])
        assert model.first_expert == held[0]
    assert _rel(got.numpy(), want) <= TOL


def test_serve_runs_jamba_whole_and_from_a_share(capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen", "3"]
    assert serve.main(argv).shape == (2, 3)
    assert serve.main(argv + ["--experts", "2:2"]).shape == (2, 3)
    out = capsys.readouterr().out
    assert out.count("prefill 8 tokens x2") == 2 and "decode  2 steps" in out
