"""The port's LM serving slice as a whole against the JAX package, on the
CPU, for the smoke configs of the four dense uniform decoders (f32).

JAX's ``init_model`` params are carried across with ``params_from_jax``
(biases and norm weights perturbed first, so that QKV bias, RMSNorm(1 + w)
and the norm scales are exercised); then the same prompt goes through
both packages: the full forward, and prefill plus 8 greedy decode steps
(per-step logits within 2e-5, identical tokens, equal cache length and
contents).  The decode also holds to the port's own teacher-forced
forward, and the port's parameter names and shapes equal JAX's.
"""

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
from repro.models import forward as jax_forward
from repro.models import init_model as jax_init
from repro.models import pad_cache as jax_pad_cache
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, port_leaves

ARCHS = ["smollm-360m", "deepseek-7b", "qwen1.5-4b", "gemma-2b"]
JRUN = JaxRun(mesh=None, remat=False)
RUN = T.RunCfg()
TOL = 2e-5
B, S, STEPS = 2, 16, 8


def _jax_params(cfg, seed):
    params, _ = jax_init(cfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(f"'{k}'" in name for k in ("bq", "bk", "bv", "w")):
            return leaf + jnp.asarray(0.2 * rng.randn(*leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, params)


def _setup(arch, seed=0):
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = _jax_params(jcfg, seed)
    model = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.RandomState(seed).randint(0, cfg.vocab, (B, S)).astype(np.int32)
    return jcfg, cfg, jp, model, toks


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, cfg, jp, model, toks = _setup(arch)
    want, _ = jax_forward(jcfg, JRUN, jp, {"tokens": jnp.asarray(toks)})
    got, _ = T.forward(cfg, RUN, model, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_jax(arch):
    jcfg, cfg, jp, model, toks = _setup(arch, seed=1)
    t_max = S + STEPS
    jl, jc = jax_prefill(jcfg, JRUN, jp, {"tokens": jnp.asarray(toks)}, t_max=t_max)
    pl, pc = T.prefill(cfg, RUN, model, {"tokens": torch.from_numpy(toks)}, t_max=t_max)
    assert pl.shape == (B, 1, cfg.vocab)
    _close(pl.numpy(), jl)
    jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    pt = pl[:, -1].argmax(-1)[:, None]
    for _ in range(STEPS):
        assert np.array_equal(np.asarray(jt), pt.numpy())
        jl, jc = jax_decode(jcfg, JRUN, jp, jc, jt)
        pl, pc = T.decode_step(cfg, RUN, model, pc, pt)
        _close(pl.numpy(), jl)
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        pt = pl[:, -1].argmax(-1)[:, None]
    assert np.array_equal(np.asarray(jt), pt.numpy())
    assert int(jc["len"]) == pc["len"] == S + STEPS
    for key in ("k", "v"):
        assert pc[key].shape == jc[key].shape
        _close(pc[key].numpy(), jc[key])


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma-2b"])
def test_collected_cache_and_pad_cache_match_jax(arch):
    jcfg, cfg, jp, model, toks = _setup(arch, seed=4)
    _, jc = jax_forward(jcfg, JRUN, jp, {"tokens": jnp.asarray(toks)}, collect_cache=True)
    _, pc = T.forward(cfg, RUN, model, {"tokens": torch.from_numpy(toks)},
                      collect_cache=True)
    jc = jax_pad_cache(jcfg, jc, S, S + 5)
    pc = T.pad_cache(cfg, pc, S, S + 5)
    assert pc["len"] == int(jc["len"]) == S
    for key in ("k", "v"):
        assert pc[key].shape == jc[key].shape == (cfg.n_layers, B, S + 5,
                                                  cfg.n_kv_heads, cfg.head_dim_)
        _close(pc[key].numpy(), jc[key])
    empty = T.init_cache(cfg, B, S + 5, device="cpu")
    assert empty["len"] == 0 and empty["k"].shape == pc["k"].shape
    assert not empty["k"].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_matches_teacher_forced_forward(arch):
    _, cfg, _, model, toks = _setup(arch, seed=2)
    tokens = torch.from_numpy(toks)
    full, _ = T.forward(cfg, RUN, model, {"tokens": tokens})
    last, cache = T.prefill(cfg, RUN, model, {"tokens": tokens[:, :S - 1]}, t_max=S + 4)
    _close(last[:, 0].numpy(), full[:, S - 2].numpy())
    logits, cache = T.decode_step(cfg, RUN, model, cache, tokens[:, S - 1:S])
    _close(logits[:, 0].numpy(), full[:, S - 1].numpy())
    assert cache["len"] == S


class _Shape:
    """A shape that ``port_leaves`` can unstack along its leading axis."""

    def __init__(self, shape):
        self.shape = shape

    def __getitem__(self, i):
        return _Shape(self.shape[1:])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_names_and_shapes_match_jax(arch):
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    shapes = jax.eval_shape(lambda k: jax_init(jcfg, k)[0], jax.random.PRNGKey(0))
    want = {n: tuple(leaf.shape) for n, leaf in port_leaves(
        jax.tree.map(lambda s: _Shape(tuple(s.shape)), shapes)).items()}
    for device in ("meta", "cpu"):
        model = T.init_model(cfg, seed=0, device=device)
        got = {n: tuple(p.shape) for n, p in model.named_parameters()}
        assert got == want
        assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_serve_runs_on_the_cpu(dtype, capsys):
    argv = ["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--batch", "3",
            "--prompt-len", "12", "--gen", "5"] + (["--dtype", dtype] if dtype else [])
    toks = serve.main(argv)
    assert toks.shape == (3, 5) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < 512
    out = capsys.readouterr().out
    assert "prefill 12 tokens x3" in out and "tok/s" in out


def test_serve_teacher_forcing_keeps_the_logits():
    cfg = get_config("gemma-2b", smoke=True)
    model = T.init_model(cfg, seed=3, device="cpu")
    tokens = serve.prompt_tokens(cfg, 2, 10, "cpu")
    free = serve.generate(cfg, RUN, model, tokens, 6, keep_logits=True)
    forced = serve.generate(cfg, T.RunCfg(plain_attention=True), model, tokens, 6,
                            forced=free["tokens"], keep_logits=True)
    assert len(free["logits"]) == len(forced["logits"]) == 6
    assert torch.equal(forced["tokens"], free["tokens"])
    for a, b in zip(free["logits"], forced["logits"]):
        assert torch.equal(a, b)  # on the CPU both attentions are the plain version
