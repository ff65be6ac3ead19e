"""Jamba training in the port against the JAX package, on the CPU (f32).

``repro_torch.kernels.selective_scan``'s backward and the port's Jamba
training against ``jax.grad`` of the reference, at jamba-1.5-large's SMOKE
widths (8 layers: one superblock, d 64, d_inner 128, d_state 8, 4 experts
top-2 every other layer), the JAX params made by the reference's init and
the inputs made from seeds with numpy, carried across
(``params_from_jax``):

* ``selective_scan_backward_plain`` (the kernel's dataflow: checkpoints
  every 16 steps, each chunk recomputed, walked backward, dB and dC summed
  a block of 64 channels at a time) against torch's autograd through
  ``selective_scan_plain``'s step loop, at S = 1, 16, 21 and 300 and
  d_state 8 and 16, from a nonzero state with a nonzero gradient of the
  final state: 1e-5 of each gradient's max;
* ``mamba_seq``'s gradients (every leaf, x, the conv tail and the SSM
  state) against ``jax.grad`` of the reference's ``mamba_seq`` through
  ``chunked_time_scan``: 1e-5;
* ``lm_loss`` and every leaf's gradient against the reference's (loss
  1e-5, a leaf 1e-4 of its max); one card's share of the experts
  (``experts=(0, 1)``) against the reference's whole model with the other
  experts' weights zero: the loss and the held leaves within 1e-4, the
  reference's gradients of the zeroed experts exactly 0;
* remat on against off changes no bit (21 scan launches a step against
  7, 7 backward launches either way);
* 3 steps against the reference's train step, whole and as the share
  (losses 1e-4; each leaf ||p - p_ref|| / ||p_ref|| within 1e-4: AdamW's
  g / (|g| + eps) turns the roundoff of a gradient element near zero, as
  the share's router has one at 1e-6 of its max, into an update that
  parts by up to lr in that element alone, which a bound on the max would
  charge to the whole leaf; the reference's zeroed experts stay 0);
  ``launch/train.py`` halts and resumes within 1e-4 of an
  uninterrupted run, and refuses ``--ckpt-dir`` with ``--experts``.
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
from repro.models.common import Initializer as JaxInit
from repro.models.transformer import RunCfg as JaxRun
from repro.models.transformer import init_model as jax_init
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim import adamw as jax_adamw
from repro.training import train_loop as jax_train
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.kernels import selective_scan as SS
from repro_torch.launch import train
from repro_torch.models import mamba as MB
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, port_leaves, share_leaves
from repro_torch.optim import adamw
from repro_torch.training import train_loop

ARCH = "jamba-1.5-large-398b"
JRUN = JaxRun(mesh=None, remat=False)
TOL = 1e-5
# the loss's batch: the 3-step trajectory's (pipeline batches of 4 x 16),
# so that the reference's loss and gradient compile once for the file
B, S = 4, 16
SHARE = (0, 1)
# the reference's gradients compiled at XLA's lowest backend optimisation:
# half the compile time of this file's two large jits, the same values to
# f32 roundoff (what XLA's codegen leaves out is speed, not arithmetic)
JIT_FAST = dict(compiler_options={"xla_backend_optimization_level": 0})


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


def _norm_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# --------------------------------------------------------------------------
# the recurrence's backward
# --------------------------------------------------------------------------


def _scan_inputs(rng, b, s, di, ds):
    dt = np.log1p(np.exp(rng.randn(b, s, di) - 1)).astype(np.float32)
    x, bm, cm = (rng.randn(b, s, n).astype(np.float32) for n in (di, ds, ds))
    a_log = (rng.randn(di, ds) * 0.5).astype(np.float32)
    d = rng.randn(di).astype(np.float32)
    h0 = (rng.randn(b, di, ds) * 0.3).astype(np.float32)
    return [torch.from_numpy(a) for a in (dt, x, bm, cm, a_log, d, h0)]


@pytest.mark.parametrize("ds", [8, 16])
@pytest.mark.parametrize("s", [1, SS.CKPT_STEPS, SS.CKPT_STEPS + 5, 300])
def test_backward_plain_matches_autograd_through_the_step_loop(s, ds):
    rng = np.random.RandomState(s + ds)
    b, di = 2, 70  # 70 channels: a ragged last block of 64
    ins = _scan_inputs(rng, b, s, di, ds)
    dy = torch.from_numpy(rng.randn(b, s, di).astype(np.float32))
    dh = torch.from_numpy(rng.randn(b, di, ds).astype(np.float32))
    leaves = [x.clone().requires_grad_() for x in ins]
    y, last = SS.selective_scan_plain(*leaves)
    torch.autograd.backward([y, last], [dy, dh])
    with torch.no_grad():
        y2, last2, ck = SS.selective_scan_plain(*ins, checkpoints=True)
        calls = SS.plain_bwd_calls
        got = SS.selective_scan_bwd(*ins[:6], ck, dy, dh)
    assert SS.plain_bwd_calls == calls + 1
    assert torch.equal(y2, y.detach()) and torch.equal(last2, last.detach())
    assert tuple(ck.shape) == (b, SS.checkpoint_count(s), di, ds)
    assert torch.equal(ck[:, 0], ins[6])
    for name, g, x in zip(("dt", "x", "B", "C", "A_log", "D", "h0"), got, leaves):
        assert g.shape == x.shape and g.dtype == torch.float32, name
        assert _rel(g.numpy(), x.grad.numpy()) <= TOL, name


def test_backward_takes_no_gradient_of_the_final_state_as_zero():
    ins = _scan_inputs(np.random.RandomState(7), 1, 20, 16, 8)
    _, _, ck = SS.selective_scan_plain(*ins, checkpoints=True)
    dy = torch.from_numpy(np.random.RandomState(8).randn(1, 20, 16).astype(np.float32))
    none = SS.selective_scan_bwd(*ins[:6], ck, dy, None)
    zero = SS.selective_scan_bwd(*ins[:6], ck, dy, torch.zeros(1, 16, 8))
    assert all(torch.equal(a, b) for a, b in zip(none, zero))
    with pytest.raises(ValueError, match="checkpoints"):
        SS.selective_scan_bwd(*ins[:6], ck[:, :1].contiguous(), dy, None)


def test_gradients_come_back_in_each_inputs_dtype():
    dt, x, bm, cm, a_log, d, h0 = _scan_inputs(np.random.RandomState(9), 2, 9, 16, 8)
    xb = x.bfloat16().requires_grad_()
    rest = [t.requires_grad_() for t in (dt, bm, cm, a_log, d, h0)]
    plain, bwd = SS.plain_calls, SS.plain_bwd_calls
    y, _ = SS.selective_scan(rest[0], xb, *rest[1:])
    y.sum().backward()
    # under autograd on the CPU: the plain forward with checkpoints, then the
    # plain backward, once each
    assert (SS.plain_calls - plain, SS.plain_bwd_calls - bwd) == (1, 1)
    assert xb.grad.dtype == torch.bfloat16
    assert all(t.grad.dtype == torch.float32 for t in rest)


# --------------------------------------------------------------------------
# a Mamba layer
# --------------------------------------------------------------------------


def test_mamba_seq_gradients_match_jax():
    cfg = get_config(ARCH, smoke=True)
    mc = cfg.mamba
    kw = dict(d_model=cfg.d_model, d_state=mc.d_state, d_conv=mc.d_conv, expand=mc.expand)
    jd, md = JMB.MambaDims(**kw), MB.MambaDims(**kw)
    mp = JMB.init_mamba(JaxInit(key=jax.random.PRNGKey(3), dtype=jnp.float32), jd)
    rng = np.random.RandomState(4)
    mp = {n: np.array(a, np.float32) for n, a in mp.items()}
    # init makes these constant: random ones reach every term
    mp.update(A_log=(rng.randn(*mp["A_log"].shape) * 0.5).astype(np.float32),
              D=rng.randn(*mp["D"].shape).astype(np.float32),
              dt_b=(rng.randn(*mp["dt_b"].shape) * 0.5).astype(np.float32),
              conv_b=(rng.randn(*mp["conv_b"].shape) * 0.1).astype(np.float32))
    s, di = 24, md.d_inner
    x = rng.randn(B, s, cfg.d_model).astype(np.float32)
    c0 = rng.randn(B, md.d_conv - 1, di).astype(np.float32)
    h0 = (rng.randn(B, di, md.d_state) * 0.3).astype(np.float32)
    gy = rng.randn(B, s, cfg.d_model).astype(np.float32)
    gc = rng.randn(B, md.d_conv - 1, di).astype(np.float32)
    gh = rng.randn(B, di, md.d_state).astype(np.float32)

    def jloss(p, a, b_, c):
        y, (conv, h) = JMB.mamba_seq(p, jd, a, b_, c)
        return jnp.sum(y * gy) + jnp.sum(conv * gc) + jnp.sum(h * gh)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)), **JIT_FAST)(
        {n: jnp.asarray(a) for n, a in mp.items()}, jnp.asarray(x), jnp.asarray(c0),
        jnp.asarray(h0))
    p = {n: torch.from_numpy(a).requires_grad_() for n, a in mp.items()}
    xs = [torch.from_numpy(a).requires_grad_() for a in (x, c0, h0)]
    bwd = SS.plain_bwd_calls
    y, (conv, h) = MB.mamba_seq(p, md, *xs)
    ((y * torch.from_numpy(gy)).sum() + (conv * torch.from_numpy(gc)).sum()
     + (h * torch.from_numpy(gh)).sum()).backward()
    assert SS.plain_bwd_calls == bwd + 1
    for name, leaf in p.items():
        assert _rel(leaf.grad.numpy(), want[0][name]) <= TOL, name
    for name, leaf, g in zip(("x", "conv_state0", "ssm_state0"), xs, want[1:]):
        assert _rel(leaf.grad.numpy(), g) <= TOL, name


# --------------------------------------------------------------------------
# the whole model
# --------------------------------------------------------------------------


def _jax_params(jcfg, seed=0):
    """The reference's params with Mamba's ``A_log``, ``D`` and ``dt_b``
    random (init makes them constant), as numpy."""
    jp, _ = jax_init(jcfg, jax.random.PRNGKey(seed))
    jp = jax.tree.map(np.array, jp)
    rng = np.random.RandomState(seed + 11)
    mamba = jp["blocks"]["mamba"]
    for name, scale, shift in (("A_log", 0.5, 0.0), ("D", 1.0, 0.0), ("dt_b", 0.5, 0.0)):
        mamba[name] = (rng.randn(*mamba[name].shape) * scale + shift).astype(np.float32)
    return jp


def _zero_other_experts(jp):
    """The reference's tree with every expert but the share's zero."""
    first, count = SHARE
    for w in jp["blocks"]["moe"]["experts"].values():
        keep = w[:, :, first:first + count].copy()
        w[...] = 0
        w[:, :, first:first + count] = keep
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


_JAX_FNS = {}


def _jax_value_and_grad(jcfg, jp, toks):
    """The reference's loss and gradients at (B, S) tokens: its train
    step's ``grads_of`` at one microbatch (one compile for the file)."""
    if "grad" not in _JAX_FNS:
        _JAX_FNS["grad"] = jax.jit(jax.value_and_grad(
            jax_train.make_loss_fn(jcfg, JRUN)), **JIT_FAST)
    return _JAX_FNS["grad"](jp, {"tokens": jnp.asarray(toks)})


@pytest.mark.parametrize("share", [False, True])
def test_lm_loss_and_gradients_match_jax(share):
    # whole, and one card's share of the experts against the reference's
    # whole model with the other experts' weights zero
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jp = _jax_params(jcfg)
    if share:
        jp = _zero_other_experts(jp)
    model = params_from_jax(cfg, jp, device="cpu", experts=SHARE if share else None)
    toks = _tokens(cfg)
    want, jg = _jax_value_and_grad(jcfg, jp, toks)
    want, jg = float(want), jax.tree.map(np.asarray, jg)
    calls, plain = SS.plain_bwd_calls, SS.plain_calls
    loss, grads = _loss_and_grads(cfg, T.RunCfg(), model, torch.from_numpy(toks))
    # a forward and a backward of the recurrence a Mamba layer
    n_mamba = cfg.n_layers - cfg.n_layers // cfg.hybrid_period
    assert (SS.plain_calls - plain, SS.plain_bwd_calls - calls) == (n_mamba,) * 2
    tol = 1e-4 if share else TOL
    assert abs(float(loss) - want) <= tol * abs(want)
    jleaves = share_leaves(cfg, jg, SHARE if share else None)
    assert set(jleaves) == set(grads) and "blocks.0.mamba.A_log" in grads
    for name, g in grads.items():
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), jleaves[name]) <= 1e-4, name
    if share:
        first, count = SHARE
        for name, g in port_leaves(jg).items():
            if ".experts." in name:
                rest = np.delete(g, range(first, first + count), axis=1)
                assert rest.size and not rest.any(), name


def test_remat_changes_no_bit():
    # one superblock: a checkpoint around it and one around each Mamba layer
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), remat=True)
    model = T.init_model(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, seed=1, b=2, s=20))
    out, calls = {}, {}
    for remat in (False, True):
        run = T.RunCfg(remat=remat)
        before = (SS.plain_calls, SS.plain_bwd_calls)
        out[remat] = _loss_and_grads(cfg, run, model, toks)
        calls[remat] = (SS.plain_calls - before[0], SS.plain_bwd_calls - before[1])
        assert calls[remat][0] == T.scan_forwards(cfg, run)
    # the forward, the superblock's recompute, each Mamba layer's own
    assert calls == {False: (7, 7), True: (21, 7)}
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(out[False][1][n], g) for n, g in out[True][1].items())


@pytest.mark.parametrize("share", [False, True])
def test_three_steps_match_jax(share):
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jp = _jax_params(jcfg, seed=3)
    if share:
        jp = _zero_other_experts(jp)
    model = params_from_jax(cfg, jp, device="cpu", experts=SHARE if share else None)
    kw = dict(lr=3e-4, warmup_steps=5, total_steps=3)
    jcf = jax_adamw.AdamWConfig(**kw)
    tc = train_loop.TrainCfg(microbatches=1, adamw=adamw.AdamWConfig(**kw))
    # the reference's train step at one microbatch, its two parts
    # (train_loop.py:47, :62): the loss's gradient, then AdamW
    if "update" not in _JAX_FNS:
        _JAX_FNS["update"] = jax.jit(lambda g, st, p: jax_adamw.update(jcf, g, st, p))
    step = train_loop.make_train_step(cfg, T.RunCfg(), tc)
    jp = jax.tree.map(jnp.asarray, jp)
    jstate = jax_adamw.init(jcf, jp)
    state = adamw.init(tc.adamw, dict(model.named_parameters()))
    pipe = pipeline.Pipeline(pipeline.DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B))
    for i in range(3):
        toks = pipe.batch_for_step(i)["tokens"]
        jloss, jg = _jax_value_and_grad(jcfg, jp, toks)
        jp, jstate, _ = _JAX_FNS["update"](jg, jstate, jp)
        loss, _ = step(model, state, {"tokens": torch.from_numpy(toks)})
        assert abs(float(loss) - float(jloss)) <= 1e-4, (i, float(loss))
    jp = jax.tree.map(np.asarray, jp)
    got = dict(model.named_parameters())
    for name, want in share_leaves(cfg, jp, SHARE if share else None).items():
        assert _norm_rel(got[name].detach().numpy(), want) <= 1e-4, name
    if share:  # AdamW leaves a zero expert at zero: no gradient, no moment
        first, count = SHARE
        for w in jp["blocks"]["moe"]["experts"].values():
            assert not np.delete(w, range(first, first + count), axis=2).any()


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
    # a share trains, and refuses a checkpoint directory
    share = train.main(argv[:-2] + ["--experts", "0:1"])
    assert len(share) == 3 and all(np.isfinite(share))
    with pytest.raises(ValueError, match="--experts"):
        train.main(argv + ck + ["--experts", "0:1"])
