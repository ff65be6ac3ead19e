"""The port's Multi-head Latent Attention and deepseek-v2-lite on one
device against the JAX package, on the CPU (f32, 1e-5 relative).

``repro_torch.models.mla`` against ``repro.models.mla``, the JAX params
carried across as numpy arrays (the SMOKE config's widths: d 64, 4 heads,
kv_lora 32, nope 16, rope 8, v 16):

* the layer's prefill in both of the port's forms, the decompressed one
  of the main path (its attention the flash kernel's plain version here)
  and the plain latent one, against JAX's ``_attend`` branch (S=16) and
  its chunked branch (B=1, S=2304, just past 2048²): the output and the
  cache entries (c_kv, k_rope);
* decode over the compressed cache, step by step, and the layer's
  gradients (params and input) in both forms;
* deepseek-v2-lite's SMOKE config through the whole model (a dense
  ``first_blocks`` block, then MLA + MoE blocks with a shared expert):
  init names, shapes and logical axes (the reference's ``model_axes``
  and specs on 2x2, ``first_blocks`` included); the forward; prefill and
  greedy decode; ``lm_loss`` and every leaf's gradient; ``pad_cache`` on
  the 4-dim MLA cache;
* ``block_forwards`` against the forwards the remat really runs (each
  stack scanned on its own, as JAX does);
* the launchers on the smoke config; each package resumes the other's
  deepseek-v2-lite checkpoint (the JAX trainer's main in this process).
"""

import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config
from repro.distributed import sharding as jax_sharding
from repro.models import mla as JMLA
from repro.models.common import Initializer as JaxInit
from repro.models.transformer import RunCfg as JaxRun
from repro.models.transformer import decode_step as jax_decode
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_model as jax_init
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.models.transformer import model_axes as jax_model_axes
from repro.models.transformer import pad_cache as jax_pad_cache
from repro.models.transformer import prefill as jax_prefill
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import attention
from repro_torch.launch import serve, train
from repro_torch.models import mla as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import (axes_to_jax_tree, params_from_jax, params_to_jax_tree,
                                        port_leaves)

ARCH = "deepseek-v2-lite-16b"
JRUN = JaxRun(mesh=None, remat=False)
TOL = 1e-5
FORMS = ["decompressed", "latent"]


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


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _dims():
    cfg = get_config(ARCH, smoke=True)
    fields = dict(d_model=cfg.d_model, n_heads=cfg.n_heads, **dataclasses.asdict(cfg.mla))
    return JMLA.MLADims(**fields), M.MLADims(**fields)


def _layer(b, s, seed=0):
    jm, m = _dims()
    jp = JMLA.init_mla(JaxInit(key=jax.random.PRNGKey(seed), dtype=jnp.float32), jm)
    x = np.random.RandomState(seed + 1).randn(b, s, jm.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    return jm, m, jp, x, pos


def _port_apply(form, p, m, x, pos):
    fn = M.apply_mla if form == "decompressed" else M.apply_mla_latent
    return fn(p, m, x, torch.from_numpy(pos.copy()))


@functools.lru_cache(maxsize=None)
def _jax_prefill(b, s):
    """JAX's layer output and cache entries (computed once for both forms)."""
    jm, _, jp, x, pos = _layer(b, s)
    out, (c, k) = jax.jit(lambda p, xx, ps: JMLA.apply_mla(p, jm, xx, ps))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    return np.asarray(out), np.asarray(c), np.asarray(k)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("b,s", [(2, 16), (1, 2304)], ids=["attend", "chunked"])
def test_mla_prefill_matches_jax_on_both_branches(form, b, s):
    _, m, jp, x, pos = _layer(b, s)
    assert (s * s > 2048 ** 2) == (s == 2304)
    want, jc, jk = _jax_prefill(b, s)
    plain = attention.plain_calls
    got, (c, k) = _port_apply(form, _to_torch(jp), m, torch.from_numpy(x), pos)
    # the decompressed form's attention is one call of the flash kernel's
    # wrapper (its plain version on the CPU); the latent form makes none
    assert attention.plain_calls == plain + (form == "decompressed")
    assert got.shape == want.shape and _rel(got.numpy(), want) <= TOL
    assert _rel(c.numpy(), jc) <= TOL and _rel(k.numpy(), jk) <= TOL


def test_decompressed_operands_are_one_head_width():
    # v is zero-padded to the scores' width: one kernel launch at D = 24
    # here (192 at the config's widths), its extra columns zero
    _, m, jp, x, pos = _layer(2, 8)
    p = _to_torch(jp)
    xt = torch.from_numpy(x)
    ps = torch.from_numpy(np.ascontiguousarray(pos))
    c, k_r = M._compress(p, m, xt, ps)
    q_n, q_r = M._queries(p, m, xt, ps)
    q, k, v = M.decompress(p, m, q_n, q_r, c, k_r)
    d = m.qk_nope_dim + m.qk_rope_dim
    assert q.shape == k.shape == v.shape == (2, 8, m.n_heads, d)
    assert torch.equal(v[..., m.v_head_dim:], torch.zeros_like(v[..., m.v_head_dim:]))
    assert torch.equal(k[:, :, 0, m.qk_nope_dim:], k[:, :, -1, m.qk_nope_dim:])
    with pytest.raises(ValueError, match="v_head_dim"):
        M.decompress(p, dataclasses.replace(m, v_head_dim=d + 8), q_n, q_r, c, k_r)


def test_mla_decode_over_the_compressed_cache_matches_jax():
    b, s, t_max = 2, 10, 14
    jm, m, jp, x, pos = _layer(b, s, seed=2)
    p = _to_torch(jp)
    _, (jc, jk) = JMLA.apply_mla(jp, jm, jnp.asarray(x), jnp.asarray(pos))
    jc = jnp.pad(jc, ((0, 0), (0, t_max - s), (0, 0)))
    jk = jnp.pad(jk, ((0, 0), (0, t_max - s), (0, 0)))
    _, (c, k) = M.apply_mla(p, m, torch.from_numpy(x), torch.from_numpy(pos.copy()))
    c = torch.nn.functional.pad(c, (0, 0, 0, t_max - s))
    k = torch.nn.functional.pad(k, (0, 0, 0, t_max - s))
    rng = np.random.RandomState(3)
    decode = jax.jit(lambda xx, cc, kk, n, ps: JMLA.apply_mla_decode(jp, jm, xx, cc, kk, n,
                                                                     ps))
    for clen in range(s, t_max):
        xn = rng.randn(b, 1, jm.d_model).astype(np.float32)
        posn = np.full((b, 1), clen, np.int32)
        want, jc, jk = decode(jnp.asarray(xn), jc, jk, jnp.int32(clen), jnp.asarray(posn))
        got = M.apply_mla_decode(p, m, torch.from_numpy(xn), c, k, clen,
                                 torch.from_numpy(posn).long())
        assert _rel(got.numpy(), want) <= TOL, clen
    assert _rel(c.numpy(), jc) <= TOL and _rel(k.numpy(), jk) <= TOL
    with pytest.raises(ValueError, match="outside"):
        M.apply_mla_decode(p, m, torch.from_numpy(xn), c, k, t_max,
                           torch.from_numpy(posn).long())


@functools.lru_cache(maxsize=None)
def _jax_layer_grads():
    jm, _, jp, x, pos = _layer(2, 16, seed=4)
    r = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    jg, jx = jax.jit(jax.grad(lambda pp, xx: jnp.sum(
        JMLA.apply_mla(pp, jm, xx, jnp.asarray(pos))[0] * r), argnums=(0, 1)))(
            jp, jnp.asarray(x))
    return jax.tree.map(np.asarray, jg), np.asarray(jx), r


@pytest.mark.parametrize("form", FORMS)
def test_mla_gradients_match_jax(form):
    _, m, jp, x, pos = _layer(2, 16, seed=4)
    jg, jx, r = _jax_layer_grads()
    p = {n: t.requires_grad_() for n, t in _to_torch(jp).items()}
    xt = torch.from_numpy(x).requires_grad_()
    (_port_apply(form, p, m, xt, pos)[0] * torch.from_numpy(r)).sum().backward()
    assert _rel(xt.grad.numpy(), jx) <= TOL
    assert set(p) == set(jg) == set(M.MLA.AXES)
    for name, g in jg.items():
        assert _rel(p[name].grad.numpy(), g) <= TOL, name


# --------------------------------------------------------------------------
# deepseek-v2-lite's SMOKE config through the whole model
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    # the port's weights from a seed, carried into the JAX tree and back
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    tree = params_to_jax_tree(dict(T.init_model(cfg, seed=0, device="cpu").named_parameters()))
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    model = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (2, 16)).astype(np.int32)
    return jcfg, cfg, jp, model, toks


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_smoke_init_names_shapes_and_axes_match_jax(smoke):
    jcfg, cfg, _, model, _ = smoke
    shapes = jax.eval_shape(lambda k: jax_init(jcfg, k)[0], jax.random.PRNGKey(0))
    want = dict(_flat(params_to_jax_tree({n: p for n, p in model.named_parameters()})))
    assert {n: tuple(t.shape) for n, t in want.items()} == \
        {n: tuple(s.shape) for n, s in _flat(shapes)}
    assert "first_blocks.ff.wi_gate" in want and "blocks.ff.shared.wo" in want
    assert "first_blocks.attn.w_dkv" in want and "blocks.attn.w_uk" in want
    assert len(model.first_blocks) == 1 and len(model.blocks) == cfg.n_layers - 1
    assert axes_to_jax_tree(T.model_axes(cfg)) == jax_model_axes(jcfg)


def test_full_config_specs_on_2x2_match_jax():
    # the reference's specs of the full config, first_blocks included: the
    # heads over model, the latents (kv_lora) whole, the experts over model
    jcfg, cfg = jax_config(ARCH), get_config(ARCH)
    mesh = {"data": 2, "model": 2}
    shapes = jax.eval_shape(lambda k: jax_init(jcfg, k)[0], jax.random.PRNGKey(0))
    stand_in = type("Mesh", (), {"shape": mesh, "axis_names": tuple(mesh)})()
    want = jax_sharding.tree_specs(stand_in, jax_model_axes(jcfg), shapes)
    specs = T.param_specs(cfg, mesh)
    for name, spec in _flat(jax.tree.map(tuple, want, is_leaf=lambda s: hasattr(s, "index"))):
        stack = name.split(".")[0]
        if stack in ("blocks", "first_blocks"):
            assert specs[f"{stack}.0.{name.split('.', 1)[1]}"] == spec[1:], name
        else:
            assert specs[name] == spec, name
    assert specs["blocks.0.attn.wq"] == ("data", "model", None)
    assert specs["blocks.0.attn.w_dkv"] == ("data", None)
    assert specs["first_blocks.0.ff.wi_gate"] == ("data", "model")
    assert T.attn_tp(cfg, T.RunCfg(mesh=SH.Mesh(shape=mesh, coords={"data": 0, "model": 1}))) \
        .axes == ("model",)


def test_smoke_forward_matches_jax(smoke):
    jcfg, cfg, jp, model, toks = smoke
    want, _ = jax.jit(lambda p, t: jax_forward(jcfg, JRUN, p, {"tokens": t}))(
        jp, jnp.asarray(toks))
    plain = attention.plain_calls
    got, _ = T.forward(cfg, T.RunCfg(), model, {"tokens": torch.from_numpy(toks)})
    assert attention.plain_calls == plain + cfg.n_layers
    assert _rel(got.numpy(), want) <= TOL


def test_smoke_prefill_and_greedy_decode_match_jax(smoke):
    jcfg, cfg, jp, model, toks = smoke
    run, steps = T.RunCfg(), 6
    decode = jax.jit(lambda p, c, t: jax_decode(jcfg, JRUN, p, c, t))
    jl, jc = jax.jit(lambda p, t: jax_prefill(jcfg, JRUN, p, {"tokens": t},
                                              t_max=16 + steps))(jp, jnp.asarray(toks))
    pl, pc = T.prefill(cfg, run, model, {"tokens": torch.from_numpy(toks)},
                       t_max=16 + steps)
    m = cfg.mla
    assert tuple(pc["k"].shape) == tuple(jc["k"].shape) == (cfg.n_layers, 2, 22,
                                                            m.kv_lora_rank)
    assert tuple(pc["v"].shape) == tuple(jc["v"].shape) == (cfg.n_layers, 2, 22,
                                                            m.qk_rope_dim)
    assert _rel(pc["k"].numpy(), jc["k"]) <= TOL and _rel(pc["v"].numpy(), jc["v"]) <= TOL
    for _ in range(steps):
        assert _rel(pl.numpy(), jl) <= TOL
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        pt = pl[:, -1].argmax(-1)[:, None]
        assert np.array_equal(np.asarray(jt), pt.numpy())
        jl, jc = decode(jp, jc, jt)
        pl, pc = T.decode_step(cfg, run, model, pc, pt)
    assert _rel(pl.numpy(), jl) <= TOL
    assert _rel(pc["k"].numpy(), jc["k"]) <= TOL and _rel(pc["v"].numpy(), jc["v"]) <= TOL


def test_smoke_lm_loss_and_gradients_match_jax(smoke):
    jcfg, cfg, jp, model, toks = smoke
    loss_j, gj = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(jcfg, JRUN, p, {"tokens": jnp.asarray(toks)})))(jp)
    model.requires_grad_(True)
    try:
        loss = T.lm_loss(cfg, T.RunCfg(), model, {"tokens": torch.from_numpy(toks)})
        names, leaves = zip(*model.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    finally:
        model.requires_grad_(False)
    assert abs(float(loss.detach()) - float(loss_j)) <= TOL * abs(float(loss_j))
    want = port_leaves(jax.tree.map(np.asarray, gj))
    assert set(grads) == set(want) and "first_blocks.0.attn.w_uv" in grads
    for name, g in grads.items():
        assert _rel(g.numpy(), want[name]) <= TOL, name


def test_pad_cache_pads_the_time_axis_of_the_mla_cache(smoke):
    jcfg, cfg, _, _, _ = smoke
    rng = np.random.RandomState(5)
    m = cfg.mla
    cache = {"k": rng.randn(cfg.n_layers, 2, 7, m.kv_lora_rank).astype(np.float32),
             "v": rng.randn(cfg.n_layers, 2, 7, m.qk_rope_dim).astype(np.float32)}
    want = jax_pad_cache(jcfg, {k: jnp.asarray(v) for k, v in cache.items()}, 7, 12)
    got = T.pad_cache(cfg, {k: torch.from_numpy(v) for k, v in cache.items()}, 7, 12)
    for key in ("k", "v"):
        assert tuple(got[key].shape) == tuple(want[key].shape)
        assert np.array_equal(got[key].numpy(), np.asarray(want[key]))
    assert got["len"] == 7
    zero = T.init_cache(cfg, 2, 12, device="cpu")
    assert {k: tuple(zero[k].shape) for k in ("k", "v")} == \
        {k: tuple(want[k].shape) for k in ("k", "v")}


@pytest.mark.parametrize("n_layers", [3, 10])
def test_block_forwards_counts_the_forwards_remat_runs(n_layers):
    # 3 layers: one dense block (2 forwards with remat), 2 MoE blocks (one
    # group of 2: 4); 10: the dense block, then 9 in groups of 3 (24)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), n_layers=n_layers, remat=True)
    model = T.init_model(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(6).randint(0, cfg.vocab, (2, 8)))
    for run in (T.RunCfg(), T.RunCfg(remat=False)):
        model.requires_grad_(True)
        plain = attention.plain_calls
        loss = T.lm_loss(cfg, run, model, {"tokens": toks})
        torch.autograd.grad(loss, list(model.parameters()))
        model.requires_grad_(False)
        assert attention.plain_calls - plain == T.block_forwards(cfg, run)
    assert T.block_forwards(cfg, T.RunCfg()) == {3: 6, 10: 26}[n_layers]


def test_int8_pod_sync_takes_a_scale_a_stack():
    # the reference's compressed step quantizes each stacked tensor at one
    # scale: first_blocks' layers share theirs, blocks' layers theirs
    from repro_torch.distributed import compression as comp

    g = {"first_blocks.0.attn.wq": torch.full((3,), 1.0),
         "blocks.0.attn.wq": torch.full((3,), 2.0), "blocks.1.attn.wq": torch.full((3,), -4.0),
         "embed": torch.full((2,), 0.5)}
    scales = {n: float(v) for n, v in comp.tensor_scales(g).items()}
    assert comp.stacked_name("first_blocks.0.attn.wq") == "first_blocks.attn.wq"
    assert scales["first_blocks.0.attn.wq"] == pytest.approx(1.0 / 127)
    assert scales["blocks.0.attn.wq"] == scales["blocks.1.attn.wq"] == pytest.approx(4.0 / 127)
    assert scales["embed"] == pytest.approx(0.5 / 127)


def test_launchers_run_the_mla_smoke_config(capsys):
    toks = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen", "3"])
    assert toks.shape == (2, 3)
    losses = train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "prefill 8 tokens x2" in out and "step     1 loss" in out and "[done]" in out
    assert len(losses) == 2 and all(np.isfinite(losses))


# --------------------------------------------------------------------------
# checkpoints across packages (the JAX trainer in this process)
# --------------------------------------------------------------------------

STEPS = 3
COMMON = ["--arch", ARCH, "--smoke", "--steps", str(STEPS), "--batch", "4", "--seq",
          "32", "--ckpt-every", "1", "--log-every", "1"]


def test_each_package_resumes_the_others_mla_checkpoint(tmp_path, monkeypatch):
    # one chain of checkpoints in one directory: the port writes step 0
    # and halts; the JAX trainer (its main in this process: it installs
    # activation rules in a module global, restored after the test)
    # resumes it, runs step 1, writes it and halts; the port resumes the
    # JAX run's step 1 for step 2.  Each resumed step is held to the
    # port's uninterrupted run
    from repro.launch import train as jax_train
    from repro.models import common as jax_common

    monkeypatch.setattr(jax_common, "_ACT_RULES", dict(jax_common._ACT_RULES))
    ck = ["--ckpt-dir", str(tmp_path / "ckpt")]
    quiet = io.StringIO()
    with contextlib.redirect_stdout(quiet):
        port_ref = train.main(COMMON + ["--device", "cpu"])
        train.main(COMMON + ["--device", "cpu", "--halt-after", "1"] + ck)
        jax_from_port = jax_train.main(COMMON + ["--halt-after", "2"] + ck)
        port_from_jax = train.main(COMMON + ["--device", "cpu"] + ck)
    log = quiet.getvalue()
    assert log.count("[resume] from step 0") == log.count("[resume] from step 1") == 1
    assert len(port_ref) == STEPS
    assert len(jax_from_port) == len(port_from_jax) == 1
    assert abs(jax_from_port[0] - port_ref[1]) < 1e-4, (jax_from_port, port_ref)
    assert abs(port_from_jax[0] - port_ref[2]) < 1e-4, (port_from_jax, port_ref)
