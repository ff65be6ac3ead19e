"""RWKV-6 training in the port against the JAX package, on the CPU (f32).

``repro_torch.kernels.wkv``'s backward and the port's rwkv6-3b training
against ``jax.grad`` of the reference, at rwkv6-3b's SMOKE widths (2
layers, d 64, 4 heads of 16, d_ff 128), the JAX params and the inputs made
from seeds with numpy and carried across (``params_from_jax``):

* ``wkv6_backward_plain`` (the kernel's dataflow: checkpoints every 16
  steps, each chunk recomputed, walked backward) against torch's autograd
  through ``wkv6_plain``'s step loop, at S = 1, 32, 37 and 300 (16
  dividing S and not), from a nonzero state with a nonzero gradient of
  the final state: 1e-5 of each gradient's max;
* ``time_mix_seq``'s gradients (every leaf, ``x``, ``x_prev0``, the
  state) against ``jax.grad`` of ``rwkv_time_mix_seq``: 1e-5;
* ``lm_loss`` and every leaf's gradient against the reference's (loss
  1e-5, a leaf 1e-4 of its max, as ``tests/test_torch_train.py``);
* remat (two levels at 10 layers: groups of 5) changes no bit; the time
  axis in chunks (``SEQ_CHUNK_TOKENS`` lowered) gives one pass's
  gradients within 1e-6;
* 3 steps at 2 microbatches against the reference's train step (losses
  1e-4, params 1e-4 of their max); ``launch/train.py`` halts and resumes
  within 1e-4 of an uninterrupted run.
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
from repro.models import rwkv as JRW
from repro.models.common import Initializer as JaxInit
from repro.models.transformer import RunCfg as JaxRun
from repro.models.transformer import init_model as jax_init
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim import adamw as jax_adamw
from repro.training import train_loop as jax_train
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.kernels import wkv
from repro_torch.launch import train
from repro_torch.models import rwkv as RW
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, port_leaves
from repro_torch.optim import adamw
from repro_torch.training import train_loop

ARCH = "rwkv6-3b"
JRUN = JaxRun(mesh=None, remat=False)
TOL = 1e-5
B, S = 2, 12


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


# --------------------------------------------------------------------------
# the recurrence's backward
# --------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 32, 37, 300])
def test_backward_plain_matches_autograd_through_the_step_loop(s):
    rng = np.random.RandomState(s)
    b, h, k = 2, 3, 16
    r, kk, v = (rng.randn(b, s, h, k).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.randn(b, s, h, k) - 1)).astype(np.float32)
    u = (rng.randn(h, k) * 0.5).astype(np.float32)
    st = (rng.randn(b, h, k, k) * 0.3).astype(np.float32)
    dy = rng.randn(b, s, h, k).astype(np.float32)
    ds = rng.randn(b, h, k, k).astype(np.float32)
    ins = [torch.from_numpy(a) for a in (r, kk, v, w, u, st)]
    leaves = [x.clone().requires_grad_() for x in ins]
    y, last = wkv.wkv6_plain(*leaves)
    torch.autograd.backward([y, last], [torch.from_numpy(dy), torch.from_numpy(ds)])
    with torch.no_grad():
        y2, last2, ck = wkv.wkv6_plain(*ins, checkpoints=True)
        calls = wkv.plain_bwd_calls
        got = wkv.wkv6_bwd(*ins[:5], ck, torch.from_numpy(dy), torch.from_numpy(ds))
    assert wkv.plain_bwd_calls == calls + 1
    assert torch.equal(y2, y.detach()) and torch.equal(last2, last.detach())
    assert tuple(ck.shape) == (b, -(-s // wkv.CKPT_STEPS), h, k, k)
    assert torch.equal(ck[:, 0], ins[5])
    for name, g, x in zip(("r", "k", "v", "w", "u", "state"), got, leaves):
        assert g.shape == x.shape and g.dtype == torch.float32, name
        assert _rel(g.numpy(), x.grad.numpy()) <= TOL, name


def test_backward_takes_no_gradient_of_the_final_state_as_zero():
    gen = torch.Generator().manual_seed(7)
    ins = [torch.randn(1, 20, 2, 16, generator=gen) for _ in range(4)] + \
        [torch.randn(2, 16, generator=gen), torch.randn(1, 2, 16, 16, generator=gen)]
    _, _, ck = wkv.wkv6_plain(*ins, checkpoints=True)
    dy = torch.randn(1, 20, 2, 16, generator=gen)
    none = wkv.wkv6_bwd(*ins[:5], ck, dy, None)
    zero = wkv.wkv6_bwd(*ins[:5], ck, dy, torch.zeros(1, 2, 16, 16))
    assert all(torch.equal(a, b) for a, b in zip(none, zero))
    with pytest.raises(ValueError, match="checkpoints"):
        wkv.wkv6_bwd(*ins[:5], ck[:, :1].contiguous(), dy, None)


def test_gradients_come_back_in_each_inputs_dtype():
    gen = torch.Generator().manual_seed(8)
    r, k, v = (torch.randn(2, 9, 2, 16, generator=gen).bfloat16().requires_grad_()
               for _ in range(3))
    w = torch.rand(2, 9, 2, 16, generator=gen).requires_grad_()
    u = torch.randn(2, 16, generator=gen).requires_grad_()
    y, _ = wkv.wkv6(r, k, v, w, u, torch.zeros(2, 2, 16, 16))
    y.sum().backward()
    assert [x.grad.dtype for x in (r, k, v, w, u)] == [torch.bfloat16] * 3 + [torch.float32] * 2


# --------------------------------------------------------------------------
# the time mix
# --------------------------------------------------------------------------


def test_time_mix_seq_gradients_match_jax():
    cfg = get_config(ARCH, smoke=True)
    kw = dict(d_model=cfg.d_model, n_heads=cfg.n_heads, d_ff=cfg.d_ff)
    jd, d = JRW.RWKVDims(**kw), RW.RWKVDims(**kw)
    tm = JRW.init_rwkv_time_mix(JaxInit(key=jax.random.PRNGKey(3), dtype=jnp.float32), jd)
    rng = np.random.RandomState(4)
    tm = {n: np.array(a, np.float32) for n, a in tm.items()}
    tm.update(w0=(rng.randn(cfg.d_model) * 0.5).astype(np.float32),
              ln_w=(rng.randn(cfg.d_model) * 0.3 + 1).astype(np.float32),
              ln_b=(rng.randn(cfg.d_model) * 0.1).astype(np.float32))
    hs = jd.head_size
    x = rng.randn(B, 19, cfg.d_model).astype(np.float32)
    x0 = rng.randn(B, cfg.d_model).astype(np.float32)
    st0 = (rng.randn(B, jd.n_heads, hs, hs) * 0.3).astype(np.float32)
    gy = rng.randn(B, 19, cfg.d_model).astype(np.float32)
    gs = rng.randn(B, jd.n_heads, hs, hs).astype(np.float32)

    def jloss(p, a, b_, c):
        y, (_, st) = JRW.rwkv_time_mix_seq(p, jd, a, b_, c)
        return jnp.sum(y * gy) + jnp.sum(st * gs)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        {n: jnp.asarray(a) for n, a in tm.items()}, jnp.asarray(x), jnp.asarray(x0),
        jnp.asarray(st0))
    p = {n: torch.from_numpy(a).requires_grad_() for n, a in tm.items()}
    xs = [torch.from_numpy(a).requires_grad_() for a in (x, x0, st0)]
    y, (_, st) = RW.time_mix_seq(p, d, *xs)
    ((y * torch.from_numpy(gy)).sum() + (st * torch.from_numpy(gs)).sum()).backward()
    for name, leaf in p.items():
        assert _rel(leaf.grad.numpy(), want[0][name]) <= TOL, name
    for name, leaf, g in zip(("x", "x_prev0", "state0"), xs, want[1:]):
        assert _rel(leaf.grad.numpy(), g) <= TOL, name


# --------------------------------------------------------------------------
# the whole model
# --------------------------------------------------------------------------


def _jax_params(jcfg, seed=0):
    """The reference's params, ``w0``, ``ln_w`` and ``ln_b`` random (init
    makes them constant), as numpy."""
    jp, _ = jax_init(jcfg, jax.random.PRNGKey(seed))
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.RandomState(seed + 11)
    tm = jp["blocks"]["tm"]
    for name, scale, shift in (("w0", 0.5, 0.0), ("ln_w", 0.3, 1.0), ("ln_b", 0.1, 0.0)):
        tm[name] = (rng.randn(*tm[name].shape) * scale + shift).astype(np.float32)
    return jp


def _tokens(cfg, seed=0, b=B, s=S):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, s)).astype(np.int32)


def _loss_and_grads(cfg, run, model, toks):
    model.requires_grad_(True)
    try:
        loss = T.lm_loss(cfg, run, model, {"tokens": toks})
        names, leaves = zip(*model.named_parameters())
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))
    finally:
        model.requires_grad_(False)


def test_lm_loss_and_gradients_match_jax():
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jp = _jax_params(jcfg)
    model = params_from_jax(cfg, jp, device="cpu")
    toks = _tokens(cfg)
    want, jg = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(jcfg, JRUN, p, {"tokens": jnp.asarray(toks)})))(jp)
    calls, plain = wkv.plain_bwd_calls, wkv.plain_calls
    loss, grads = _loss_and_grads(cfg, T.RunCfg(), model, torch.from_numpy(toks))
    # a forward and a backward of the recurrence a layer
    assert (wkv.plain_calls - plain, wkv.plain_bwd_calls - calls) == (cfg.n_layers,) * 2
    assert abs(float(loss) - float(want)) <= TOL * abs(float(want))
    jleaves = port_leaves(jax.tree.map(np.asarray, jg))
    assert set(jleaves) == set(grads) and "blocks.1.tm.w0" in grads
    for name, g in grads.items():
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), jleaves[name]) <= 1e-4, name


def test_remat_changes_no_bit():
    # 10 layers: two checkpointed groups of 5, a checkpoint a layer inside
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), remat=True, n_layers=10)
    model = T.init_model(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, seed=1, b=2, s=20))
    out, calls = {}, {}
    for remat in (False, True):
        run = T.RunCfg(remat=remat)
        before = wkv.plain_calls
        out[remat] = _loss_and_grads(cfg, run, model, toks)
        calls[remat] = wkv.plain_calls - before
        assert calls[remat] == T.block_forwards(cfg, run)
    assert calls == {False: 10, True: 3 * 10 - 10 // 5}
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(out[False][1][n], g) for n, g in out[True][1].items())


def test_time_axis_in_chunks_gives_one_passs_gradients(monkeypatch):
    cfg = get_config(ARCH, smoke=True)
    model = params_from_jax(cfg, _jax_params(jax_config(ARCH, smoke=True), seed=2),
                            device="cpu")
    toks = torch.from_numpy(_tokens(cfg, seed=2, s=21))
    whole = _loss_and_grads(cfg, T.RunCfg(), model, toks)
    monkeypatch.setattr(T, "SEQ_CHUNK_TOKENS", 2 * 8)  # chunks of 8, 8, 5 at B = 2
    calls = wkv.plain_bwd_calls
    cut = _loss_and_grads(cfg, T.RunCfg(), model, toks)
    assert wkv.plain_bwd_calls == calls + 3 * cfg.n_layers  # the state's gradient carried
    assert _rel(cut[0].numpy(), whole[0].numpy()) <= 1e-6
    for name, g in whole[1].items():
        assert _rel(cut[1][name].numpy(), g.numpy()) <= 1e-6, name


def test_three_steps_at_two_microbatches_match_jax():
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jp = _jax_params(jcfg, seed=3)
    model = params_from_jax(cfg, jp, device="cpu")
    kw = dict(lr=3e-4, warmup_steps=5, total_steps=3)
    jt = jax_train.TrainCfg(microbatches=2, adamw=jax_adamw.AdamWConfig(**kw))
    tc = train_loop.TrainCfg(microbatches=2, adamw=adamw.AdamWConfig(**kw))
    jstep = jax.jit(jax_train.make_train_step(jcfg, JRUN, jt))
    step = train_loop.make_train_step(cfg, T.RunCfg(), tc)
    jp = jax.tree.map(jnp.asarray, jp)
    jstate = jax_adamw.init(jt.adamw, jp)
    state = adamw.init(tc.adamw, dict(model.named_parameters()))
    pipe = pipeline.Pipeline(pipeline.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))
    for i in range(3):
        batch = pipe.batch_for_step(i)
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(x) for k, x in batch.items()})
        loss, _ = step(model, state, {k: torch.from_numpy(x) for k, x in batch.items()})
        assert abs(float(loss) - float(jm["loss"])) <= 1e-4, (i, float(loss))
    for name, want in port_leaves(jax.tree.map(np.asarray, jp)).items():
        got = dict(model.named_parameters())[name].detach()
        assert _rel(got.numpy(), want) <= 1e-4, name


def test_launcher_halts_and_resumes(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--ckpt-every", "1"]
    whole = train.main(argv)
    ck = ["--ckpt-dir", str(tmp_path / "ckpt")]
    first = train.main(argv + ck + ["--halt-after", "2"])
    rest = train.main(argv + ck)
    out = capsys.readouterr().out
    assert "[halt]" in out and "[resume] from step 1" in out
    assert len(first) == 2 and len(rest) == 1
    assert np.allclose(first + rest, whole, rtol=0, atol=1e-4), (first + rest, whole)
