"""The port's int8 KV cache against the JAX package, on the CPU (f32
smoke configs, 2 torch threads).

* ``kvquant.quantize`` / ``dequantize`` bitwise the JAX functions' on the
  same numpy inputs, in f32 and bf16 (a row of zeros: the 1e-8 floor;
  values at ±amax; halves that round to even);
* the int8 decode from ``init_cache`` against ``repro``'s, 8 greedy steps
  at smollm-360m's and qwen3-moe-30b-a3b's smoke configs: each step's
  logits within 1e-4·max|logit|, the same greedy tokens, the int8 entries
  equal in ≥ 99.9 % of places and at most one level apart elsewhere;
* prefill, then the int8 decode, against the JAX side composed of the
  reference's own functions: its ``prefill``, ``kvquant.quantize`` of its
  k and v, then its ``decode_step`` (the reference's prefill returns a
  float cache its int8 decode cannot read: ``KeyError: 'k_scale'``);
* the port's counterpart of
  ``tests/test_attention.py::test_int8_kv_cache_decode_close_to_bf16``;
* MLA with ``kv_quant`` decodes as without it (its compressed cache);
  GQA with ``first_dense`` leading blocks and ``kv_quant`` is refused.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config
from repro.models import RunCfg as JaxRun
from repro.models import decode_step as jax_decode
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init
from repro.models import kvquant as JKQ
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_config
from repro_torch.models import kvquant as KQ
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

JRUN = JaxRun(mesh=None, remat=False)
RUN = T.RunCfg()
B, S, STEPS = 2, 8, 8
LOGIT_TOL = 1e-4
ARCHS = ["smollm-360m", "qwen3-moe-30b-a3b"]


@pytest.fixture(autouse=True, scope="module")
def _share_the_host():
    # the suite runs test files side by side (xdist), one a core or so: torch's
    # pool on every core then spends its time waiting on the others
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _quant(arch, **kw):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), kv_quant=True, **kw)
    cfg = dataclasses.replace(get_config(arch, smoke=True), kv_quant=True, **kw)
    return jcfg, cfg


def _setup(arch, seed=0):
    jcfg, cfg = _quant(arch)
    jp, _ = jax_init(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, model


def _bits(x):
    """Exact bits of a torch or JAX tensor, as a numpy array to compare."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _inputs():
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 6, 3, 32) * rng.uniform(1e-3, 30.0, (4, 6, 3, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0                         # the 1e-8 floor
    x[0, 1, 1, :2] = [5.0, -5.0]             # ±amax of its row
    x[0, 1, 1, 2:] = rng.uniform(-5.0, 5.0, 30)
    # halves: amax 127 makes the scale 1, so these sit at .5 exactly
    x[1, 2, 0] = np.concatenate([[127.0], np.arange(31) - 15.5]).astype(np.float32)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_are_bitwise_jax(dtype):
    x = _inputs()
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert np.array_equal(_bits(tx), _bits(jx))
    jq, js = JKQ.quantize(jx)
    tq, ts = KQ.quantize(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.shape == jq.shape and ts.shape == js.shape == x.shape[:-1] + (1,)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(_bits(ts), _bits(js))
    assert float(ts[0, 0, 0, 0]) == np.float32(1e-8) / np.float32(127.0)
    assert set(np.unique(tq[0, 1, 1, :2].numpy())) == {-127, 127}
    for out in ("float32", "bfloat16"):
        jd = JKQ.dequantize(jq, js, getattr(jnp, out))
        td = KQ.dequantize(tq, ts, getattr(torch, out))
        assert td.dtype == getattr(torch, out)
        assert np.array_equal(_bits(td), _bits(jd))


def test_int8_cache_layout_matches_jax():
    jcfg, cfg = _quant("smollm-360m")
    want = jax_init_cache(jcfg, B, 16)
    got = T.init_cache(cfg, B, 16, device="cpu")
    assert set(got) == set(want)
    for key in ("k", "v", "k_scale", "v_scale"):
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
    assert got["k"].dtype == torch.int8 and got["k_scale"].shape[-1] == 1


def _check_cache(pc, jc, upto):
    """The int8 entries: equal in ≥ 99.9 % of places, one level apart at
    most elsewhere; the scales of the positions written within 1e-5."""
    for key in ("k", "v"):
        got, want = pc[key].numpy().astype(np.int32), np.asarray(jc[key], np.int32)
        assert got.shape == want.shape
        d = np.abs(got - want)
        assert d.max() <= 1 and (d == 0).mean() >= 0.999, (key, d.max(), (d == 0).mean())
        g = pc[key + "_scale"].numpy()[:, :, :upto]
        w = np.asarray(jc[key + "_scale"])[:, :, :upto]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)


def _decode_both(jcfg, cfg, jp, model, jc, pc, jt, pt):
    decode = jax.jit(functools.partial(jax_decode, jcfg, JRUN))
    for step in range(STEPS):
        assert np.array_equal(np.asarray(jt), pt.numpy()), step
        jl, jc = decode(jp, jc, jt)
        pl, pc = T.decode_step(cfg, RUN, model, pc, pt)
        assert pl.shape == jl.shape
        assert _rel(pl.numpy(), jl) <= LOGIT_TOL, (step, _rel(pl.numpy(), jl))
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        pt = pl[:, -1].argmax(-1)[:, None]
    assert np.array_equal(np.asarray(jt), pt.numpy())
    assert pc["len"] == int(jc["len"])
    return jc, pc


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_decode_from_init_cache_matches_jax(arch):
    jcfg, cfg, jp, model = _setup(arch, seed=1)
    jc = jax_init_cache(jcfg, B, STEPS)
    pc = T.init_cache(cfg, B, STEPS, device="cpu")
    first = np.random.RandomState(1).randint(0, cfg.vocab, (B, 1)).astype(np.int32)
    jc, pc = _decode_both(jcfg, cfg, jp, model, jc, pc, jnp.asarray(first),
                          torch.from_numpy(first))
    _check_cache(pc, jc, STEPS)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_int8_decode_matches_composed_jax(arch):
    jcfg, cfg, jp, model = _setup(arch, seed=2)
    toks = np.random.RandomState(2).randint(0, cfg.vocab, (B, S)).astype(np.int32)
    t_max = S + STEPS
    # the reference's prefill returns k and v in the compute dtype: its own
    # quantize makes them the int8 cache its decode reads
    jl, jfloat = jax_prefill(jcfg, JRUN, jp, {"tokens": jnp.asarray(toks)}, t_max=t_max)
    (kq, ks), (vq, vs) = JKQ.quantize(jfloat["k"]), JKQ.quantize(jfloat["v"])
    jc = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs, "len": jfloat["len"]}
    pl, pc = T.prefill(cfg, RUN, model, {"tokens": torch.from_numpy(toks)}, t_max=t_max)
    assert pc["len"] == S and pc["k"].dtype == torch.int8
    assert _rel(pl.numpy(), jl) <= LOGIT_TOL
    _check_cache(pc, jc, S)
    jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    jc, pc = _decode_both(jcfg, cfg, jp, model, jc, pc, jt, pl[:, -1].argmax(-1)[:, None])
    _check_cache(pc, jc, S + STEPS)


def test_int8_decode_close_to_float_cache():
    # the port's tests/test_attention.py::test_int8_kv_cache_decode_close_to_bf16
    cfg = get_config("deepseek-7b", smoke=True)
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    model = T.init_model(cfg, seed=7, device="cpu")
    rng = np.random.RandomState(7)
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    cacheq = T.init_cache(cfgq, 2, 16, device="cpu")
    assert cacheq["k"].dtype == torch.int8 and cache["k"].dtype == torch.float32
    agree = 0
    for t in range(8):
        tok = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 1)))
        lo, cache = T.decode_step(cfg, RUN, model, cache, tok)
        lq, cacheq = T.decode_step(cfgq, RUN, model, cacheq, tok)
        err = _rel(lq.numpy(), lo.numpy())
        assert err < 0.08, (t, err)
        agree += int(lo[0, -1].argmax() == lq[0, -1].argmax())
    assert agree >= 7  # top-1 agreement on ≥7/8 steps


def test_mla_with_kv_quant_decodes_as_without():
    # the reference's init_cache returns MLA's compressed cache first, and
    # its decode takes the generic branch: kv_quant changes nothing there
    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    model = T.init_model(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(3).randint(0, cfg.vocab, (B, S)))
    outs = []
    for c in (cfg, cfgq):
        logits, cache = T.prefill(c, RUN, model, {"tokens": toks}, t_max=S + 3)
        assert set(cache) == {"k", "v", "len"} and cache["k"].dtype == torch.float32
        steps = [logits]
        for _ in range(3):
            logits, cache = T.decode_step(c, RUN, model, cache, logits[:, -1:].argmax(-1))
            steps.append(logits)
        outs.append(torch.cat(steps, 1))
    assert torch.equal(outs[0], outs[1])


def test_gqa_with_leading_dense_blocks_and_kv_quant_is_refused():
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    bad = dataclasses.replace(cfg, kv_quant=True,
                              moe=dataclasses.replace(cfg.moe, first_dense=1))
    with pytest.raises(ValueError, match="first_dense"):
        T.init_model(bad, device="cpu")
    with pytest.raises(ValueError, match="first_dense"):
        T.init_cache(bad, 1, 4, device="cpu")
