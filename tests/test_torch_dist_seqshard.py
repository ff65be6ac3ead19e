"""The port's sequence-sharded decode and its int8 cache on a mesh, on the
CPU (gloo ranks, smollm-360m's SMOKE config: 2 layers, d 60, 3 heads, 1 kv
head of 20, f32), against the JAX package on 4 fake CPU devices (a child
process: this file run as a script) and against the port's own 1x1.

One spawn of 4 ranks runs on 4x1, then re-cuts itself into 2x2, where the
cache's head_dim lies over ``model`` (its one kv head does not divide).
Held:

* ``layers.decode_attention_seqsharded`` on 4x1 against the reference's
  inside ``shard_map`` on 4 fake devices, with the reference test's shapes
  (``tests/test_attention.py:65``: B=1, T=64, 8 heads on 2, D=8, ``clen``
  37), within 2e-5;
* smollm decoding 4 greedy steps with ``seq_shard_kv`` on 4x1 and on 2x2
  (the prompt 11 tokens, the cache 16 positions: the new entries cross a
  slab's edge) against the JAX decode with ``seq_shard_kv`` on the same
  meshes of fake devices and against the port's dense 1x1 decode: the same
  tokens, logits within 1e-5·max|logit|; each rank holds its time slab;
* the sequence-sharded decode of qwen1.5-4b's and gemma-2b's smoke
  configs on 2x2 (their query heads cut over ``model``; qwen's cache cut
  on its kv heads, gemma's on its head_dim) against the port's dense 1x1;
* the int8 decode on 2x2 (each entry's scale the max over ``model``)
  against 1x1's int8 decode, and ``kv_quant`` with ``seq_shard_kv`` on 4x1
  (the reference's int8 decode first: the slabs are gathered to be read)
  against 1x1's int8, logits within 1e-5·max|logit|, the same tokens, the
  int8 entries equal in ≥ 99.9 % of places (one level apart at most) and
  the scales within 1e-5 (the sums of a mesh round in another order).
"""

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
from repro_torch.launch import mesh as M
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, params_from_jax_sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "smollm-360m"
B, PROMPT, GEN, SEED = 2, 11, 5, 0
T_MAX = PROMPT + GEN
# the reference test's attention inputs
ATT = dict(b=1, t=64, h=8, hkv=2, d=8, clen=37)
TOL = 1e-5
# their heads cut over model on 2x2: qwen's kv heads with them (the cache's
# kv heads cut), gemma's one kv head whole (the cache's head_dim cut)
OTHER_ARCHS = {"qwen1.5-4b": 3, "gemma-2b": 4}


def _tokens(vocab):
    return np.random.RandomState(5).randint(0, vocab, (B, PROMPT)).astype(np.int32)


def _att_inputs():
    rng = np.random.RandomState(11)
    a = ATT
    return (rng.randn(a["b"], 1, a["h"], a["d"]).astype(np.float32),
            rng.randn(a["b"], a["t"], a["hkv"], a["d"]).astype(np.float32),
            rng.randn(a["b"], a["t"], a["hkv"], a["d"]).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


# --------------------------------------------------------------------------
# the JAX side on 4 fake devices (a child process)
# --------------------------------------------------------------------------


def _jax_side(out: str) -> None:
    from repro.launch.mesh import ensure_host_devices
    ensure_host_devices(4)
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.configs import get_config as jax_config
    from repro.launch.mesh import make_dev_mesh, mesh_axes
    from repro.models import layers as JL
    from repro.models import RunCfg as JaxRun
    from repro.models import decode_step, init_model, prefill

    res = {}
    # the primitive, as tests/test_attention.py runs it
    q, k, v = (jnp.asarray(x) for x in _att_inputs())
    clen = ATT["clen"]

    def local(qq, ks, vs):
        r = jax.lax.axis_index("data")
        tl = ks.shape[1]
        valid = jnp.broadcast_to(((r * tl + jnp.arange(tl))[None, :] <= clen),
                                 (qq.shape[0], tl))
        return JL.decode_attention_seqsharded(qq, ks, vs, valid, "data")

    kv = P(None, "data", None, None)
    res["attention"] = np.asarray(jax.jit(shard_map(
        local, mesh=make_dev_mesh(4, 1), in_specs=(P(), kv, kv), out_specs=P(),
        check_vma=False))(q, k, v))
    # smollm decoding with the time-sharded cache
    cfg = jax_config(ARCH, smoke=True)
    params, _ = init_model(cfg, jax.random.PRNGKey(SEED))
    toks = jnp.asarray(_tokens(cfg.vocab))
    for shape in ((4, 1), (2, 2)):
        mesh = make_dev_mesh(*shape)
        dax, max_ = mesh_axes(mesh)
        run = JaxRun(mesh=mesh, data_axes=dax, model_axes=max_, seq_shard_kv=True,
                     remat=False)
        pre = jax.jit(lambda p, bt, run=run: prefill(cfg, run, p, bt, t_max=T_MAX))
        dec = jax.jit(lambda p, c, t, run=run: decode_step(cfg, run, p, c, t))
        with mesh:
            lg, cache = pre(params, {"tokens": toks})
            for i in range(GEN):
                res[f"{shape[0]}x{shape[1]}/{i}"] = np.asarray(lg)
                if i + 1 < GEN:
                    tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
                    lg, cache = dec(params, cache, tok)
    np.savez(out, **res)


# --------------------------------------------------------------------------
# the port's ranks
# --------------------------------------------------------------------------


def _serve(cfg, run, model, toks):
    r = serve.generate(cfg, run, model, toks, GEN, keep_logits=True)
    return {"tokens": r["tokens"].numpy(), "logits": [x.numpy() for x in r["logits"]],
            "cache": {k: v.numpy() for k, v in r["cache"].items() if k != "len"}}


def _attention_4x1(ctx):
    run = T.RunCfg(mesh=M.mesh_of(ctx))
    q, k, v = (torch.from_numpy(x) for x in _att_inputs())
    r, count = ctx.rank, ctx.p
    tl = ATT["t"] // count
    valid = (r * tl + torch.arange(tl) <= ATT["clen"])[None, :].expand(ATT["b"], tl)
    sl = slice(r * tl, (r + 1) * tl)
    return L.decode_attention_seqsharded(q, k[:, sl], v[:, sl], valid,
                                         run.data_axes).numpy()


def _ranks(ctx, jtree):
    import dataclasses

    M.share_host(ctx)
    cfg = get_config(ARCH, smoke=True)
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    toks = torch.from_numpy(_tokens(cfg.vocab))
    out = {"attention": _attention_4x1(ctx)}
    for label in ("4x1", "2x2"):
        if label == "2x2":
            ctx = M.regrid_mesh({"data": 2, "model": 2})
        mesh = M.mesh_of(ctx)
        seq = T.RunCfg(mesh=mesh, seq_shard_kv=True)
        model = params_from_jax_sharded(cfg, jtree, mesh, device="cpu")
        out[f"{label}/seq"] = _serve(cfg, seq, model, toks)
        out[f"{label}/tp"] = T.attn_tp(cfg, seq, cache=True).cache_dim
        int8_run = seq if label == "4x1" else T.RunCfg(mesh=mesh)
        out[f"{label}/int8"] = _serve(cfgq, int8_run, model, toks)
    for arch in OTHER_ARCHS:  # heads cut over model on 2x2
        c = get_config(arch, smoke=True)
        seq = T.RunCfg(mesh=mesh, seq_shard_kv=True)
        other = T.init_model(c, seed=SEED, device="cpu", mesh=mesh)
        out[f"{arch}/seq"] = _serve(c, seq, other, torch.from_numpy(_tokens(c.vocab)))
        out[f"{arch}/tp"] = (T.attn_tp(c, seq, cache=True).cache_dim, T.attn_tp(c, seq).axes)
    return out


@pytest.fixture(scope="module")
def runs():
    import jax

    from repro.configs import get_config as jax_config
    from repro.models import init_model as jax_init

    tmp = tempfile.mkdtemp()
    out = os.path.join(tmp, "jax.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__), out], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        jp, _ = jax_init(jax_config(ARCH, smoke=True), jax.random.PRNGKey(SEED))
        jtree = jax.tree.map(np.asarray, jp)
        got = dist.run_ranks(_ranks, 4, 1, device="cpu", args=(jtree,))
        cfg = get_config(ARCH, smoke=True)
        model = params_from_jax(cfg, jtree, device="cpu")
        toks = torch.from_numpy(_tokens(cfg.vocab))
        import dataclasses
        one = {"dense": _serve(cfg, T.RunCfg(), model, toks),
               "int8": _serve(dataclasses.replace(cfg, kv_quant=True), T.RunCfg(), model,
                              toks)}
        for arch in OTHER_ARCHS:
            c = get_config(arch, smoke=True)
            one[arch] = _serve(c, T.RunCfg(), T.init_model(c, seed=SEED, device="cpu"),
                               torch.from_numpy(_tokens(c.vocab)))
    finally:
        torch.set_num_threads(threads)
    _, err = child.communicate(timeout=600)
    assert child.returncode == 0, err[-3000:]
    with np.load(out) as z:
        want = dict(z)
    return got, one, want


def test_combine_on_4x1_matches_jax_on_4_fake_devices(runs):
    got, _, want = runs
    for r in got:
        np.testing.assert_allclose(r["attention"], want["attention"], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_seq_sharded_decode_matches_jax_and_the_dense_1x1(runs, mesh):
    got, one, want = runs
    r = got[0][f"{mesh}/seq"]
    assert got[0][f"{mesh}/tp"] == (3 if mesh == "4x1" else 4)  # 4x1: a model axis of 1
    jax_logits = [want[f"{mesh}/{i}"] for i in range(GEN)]
    assert np.array_equal(r["tokens"], np.stack([np.argmax(x[:, -1], -1)
                                                 for x in jax_logits], 1))
    assert np.array_equal(r["tokens"], one["dense"]["tokens"])
    for a, j, d in zip(r["logits"], jax_logits, one["dense"]["logits"]):
        assert a.shape == j.shape == d.shape
        assert _rel(a, j) <= TOL and _rel(a, d) <= TOL
    # each rank holds its slab of the time axis, its rows whole
    data = 4 if mesh == "4x1" else 2
    for rank, g in enumerate(got):
        k = g[f"{mesh}/seq"]["cache"]["k"]
        full = one["dense"]["cache"]["k"]
        assert k.shape[:3] == (full.shape[0], B, T_MAX // data)
        i = rank // (1 if mesh == "4x1" else 2)
        tl = T_MAX // data
        lo, hi = (0, full.shape[-1]) if mesh == "4x1" else (
            (rank % 2) * 10, (rank % 2 + 1) * 10)
        assert np.max(np.abs(k - full[:, :, i * tl:(i + 1) * tl, :, lo:hi])) <= \
            TOL * np.max(np.abs(full))


@pytest.mark.parametrize("arch", sorted(OTHER_ARCHS))
def test_seq_sharded_decode_with_heads_cut_matches_the_dense_1x1(runs, arch):
    # 2x2 with the query heads cut over model too: qwen's cache cut on its
    # kv heads, gemma's on its head_dim (each slab's head_dim gathered)
    got, one, _ = runs
    r, w = got[0][f"{arch}/seq"], one[arch]
    assert got[0][f"{arch}/tp"] == (OTHER_ARCHS[arch], ("model",))
    assert np.array_equal(r["tokens"], w["tokens"])
    for a, b in zip(r["logits"], w["logits"]):
        assert a.shape == b.shape and _rel(a, b) <= TOL


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_int8_decode_on_a_mesh_matches_1x1(runs, mesh):
    # 2x2: the head_dim cut over model, each entry's scale the max over it;
    # 4x1: the cache's time axis cut as well (kv_quant with seq_shard_kv)
    got, one, _ = runs
    r, w = got[0][f"{mesh}/int8"], one["int8"]
    assert np.array_equal(r["tokens"], w["tokens"])
    for a, b in zip(r["logits"], w["logits"]):
        assert _rel(a, b) <= TOL
    data = 4 if mesh == "4x1" else 1
    tl = T_MAX // data
    for rank, g in enumerate(got):
        c = g[f"{mesh}/int8"]["cache"]
        assert c["k"].dtype == np.int8 and c["k_scale"].dtype == np.float32
        # 4x1: the rows whole, the time axis cut; 2x2: the rows over data
        t0 = (rank if mesh == "4x1" else 0) * tl
        rows = slice(0, B) if mesh == "4x1" else slice(rank // 2, rank // 2 + 1)
        lo, hi = (0, 20) if mesh == "4x1" else ((rank % 2) * 10, (rank % 2 + 1) * 10)
        for key in ("k", "v"):
            want = w["cache"][key][:, rows, t0:t0 + tl, :, lo:hi]
            d = np.abs(c[key].astype(np.int32) - want.astype(np.int32))
            assert d.max() <= 1 and (d == 0).mean() >= 0.999, (mesh, rank, key)
            np.testing.assert_allclose(c[key + "_scale"],
                                       w["cache"][key + "_scale"][:, rows, t0:t0 + tl],
                                       rtol=1e-5, atol=0)


if __name__ == "__main__":
    _jax_side(sys.argv[1])
