"""The port's attention pieces against the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
and its port: the flash-attention kernel's plain version against JAX's
Pallas ``flash_attention`` in interpret mode (f32 at 2e-5 as
``tests/test_flash_kernel.py``, bf16 at 3e-2 and by ``bf16_gap``, the
bf16 check that the card's tests use), and the plain layers
(``_sdpa_direct``, ``_sdpa_chunked``, RoPE, ``rms_norm``, the three MLPs)
in f32 within 1e-6 of the largest reference value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.kernels.attention import flash_attention as jax_flash
from repro.models import common as jcm
from repro.models import layers as JL
from repro_torch.kernels import attention as A
from repro_torch.models import common as cm
from repro_torch.models import layers as L

REL = 1e-6


def _qkv(b, s, t, h, hkv, d, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, d).astype(dtype), rng.randn(b, t, hkv, d).astype(dtype),
            rng.randn(b, t, hkv, d).astype(dtype))


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# the kernels' causal mask is aligned at the top left: causal runs S == T
@pytest.mark.parametrize("d", [16, 20, 32])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("s,t,causal", [(64, 64, True), (64, 64, False),
                                        (128, 64, False), (64, 128, False)])
def test_flash_plain_matches_jax_kernel(s, t, causal, h, hkv, d):
    q, k, v = _qkv(2, s, t, h, hkv, d, seed=s + t + h + hkv + d)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     blk_q=32, blk_k=32, interpret=True)
    before = A.plain_calls, A.launches
    got = A.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal, blk_q=32, blk_k=32)
    assert (A.plain_calls, A.launches) == (before[0] + 1, before[1])
    assert got.dtype == torch.float32 and got.shape == (2, s, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("blk", [(16, 64), (64, 16), (128, 128)])
def test_flash_plain_block_shapes(blk):
    q, k, v = _qkv(1, 128, 128, 6, 2, 16, seed=5)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                     blk_q=blk[0], blk_k=blk[1], interpret=True)
    got = A.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=True, blk_q=blk[0], blk_k=blk[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_flash_plain_bf16_matches_jax_kernel():
    q, k, v = _qkv(1, 64, 64, 6, 2, 64, seed=3)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jax_flash(jq, jk, jv, causal=True, blk_q=16, blk_k=16, interpret=True)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
                  for x in (jq, jk, jv))
    got = A.flash_attention(tq, tk, tv, causal=True, blk_q=16, blk_k=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)
    gap = A.bf16_gap(got, torch.from_numpy(np.asarray(want, np.float32)))
    assert gap["ok"], gap


@pytest.mark.parametrize("control,accepted", [
    ({}, True), ({"round_p": True}, False), ({"drop_tile": True}, False)])
def test_bf16_check_refuses_broken_attention(control, accepted):
    # an unblocked attention sums in another order than the plain version
    # and passes; rounding p to bf16 or dropping a key tile does not
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(1, 512, 512, 6, 2, 64, seed=9))
    want = A.flash_attention_plain(q, k, v, causal=True)
    gap = A.bf16_gap(A.bf16_control(q, k, v, **control), want)
    assert gap["ok"] == accepted, gap


def test_flash_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 3, 8)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        A.flash_attention(x, torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        A.flash_attention(x.double(), x.double(), x.double())
    with pytest.raises(ValueError, match="non-empty"):
        A.flash_attention(x, torch.zeros(1, 0, 3, 8), torch.zeros(1, 0, 3, 8))
    big = torch.zeros(1, 4, 1, 264)
    with pytest.raises(ValueError, match="head dimension"):
        A.flash_attention(big, big, big)
    meta = torch.zeros(1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        A.flash_attention(meta, meta, meta)


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """x as a view one element into a wider buffer: its base is no longer
    16-byte aligned, its strides are."""
    d = x.shape[-1]
    buf = torch.zeros(x.shape[:3] + (d + 8,), dtype=x.dtype)
    buf[..., 1:d + 1] = x
    return buf[..., 1:d + 1]


# the bf16 kernel's operands as its tensor maps read them: D=20 is padded to
# 24 (scores still scaled by 1/sqrt(20)), a misaligned base is copied, and
# aligned contiguous operands pass as they are
@pytest.mark.parametrize("case,d,dg,copied", [("d20", 20, 24, True), ("unaligned", 32, 32, True),
                                              ("as_is", 32, 32, False)])
def test_tma_operands_match_jax_kernel(case, d, dg, copied):
    q, k, v = _qkv(2, 64, 64, 8, 2, d, seed=21 + d)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                     blk_q=32, blk_k=32, interpret=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    if case == "unaligned":
        tq, tk, tv = (_unaligned(x) for x in (tq, tk, tv))
        assert not A.tma_ready(tq, dg)
    pq, pk, pv, got_dg, got_copied = A.tma_operands(tq, tk, tv)
    assert (got_dg, got_copied) == (dg, copied)
    for x, p in zip((tq, tk, tv), (pq, pk, pv)):
        assert A.tma_ready(p, dg) and p.shape == x.shape[:3] + (dg,)
        assert (p is x) == (not copied)
        assert torch.equal(p[..., :d], x) and not p[..., d:].any()
    got = A.flash_attention_plain(pq, pk, pv, causal=True, blk_q=32, blk_k=32,
                                  scale=1.0 / d ** 0.5)[..., :d]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_tma_strides_step_no_size_one_dimension():
    # a dimension of size 1 takes the contiguous stride, whatever view made it
    assert A.tma_strides(torch.zeros(1, 5, 1, 16)) == (80, 16, 16)
    odd = torch.zeros(2, 7, 8).as_strided((2, 7, 1, 8), (56, 8, 3, 1))
    assert A.tma_strides(odd) == (56, 8, 8) and A.tma_ready(odd, 8)
    head = torch.zeros(2, 7, 3, 8)[:, :, 1:2]     # one kv head of three
    assert A.tma_strides(head) == (168, 24, 8)


def test_attention_flops_counts_the_kept_pairs():
    # causal: S(S+1)/2 pairs a head; full: S·T
    assert A.attention_flops(8, 2048, 2048, 15, 64, True) == 4.0 * 8 * 15 * 64 * 2048 * 2049 / 2
    assert A.attention_flops(1, 3, 5, 2, 4, False) == 4.0 * 2 * 4 * 15


def _dims(h, hkv, d):
    return JL.AttnDims(d_model=h * d, n_heads=h, n_kv_heads=hkv, head_dim=d), \
        L.AttnDims(d_model=h * d, n_heads=h, n_kv_heads=hkv, head_dim=d)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("h,hkv", [(6, 2), (4, 4), (4, 1)])
def test_sdpa_direct_matches_jax(h, hkv, masked):
    q, k, v = _qkv(2, 24, 24, h, hkv, 16, seed=h + hkv)
    ja, pa = _dims(h, hkv, 16)
    mask = (np.arange(24)[None, :] <= np.arange(24)[:, None])[None, None, None] \
        if masked else None
    want = JL._sdpa_direct(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ja,
                           None if mask is None else jnp.asarray(mask))
    got = L._sdpa_direct(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         pa, None if mask is None else torch.from_numpy(mask))
    _close(got.numpy(), want)


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_chunked_matches_jax(causal):
    q, k, v = _qkv(2, 64, 64, 6, 2, 16, seed=11)
    ja, pa = _dims(6, 2, 16)
    want = JL._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ja,
                            causal=causal, q_chunk=16, k_chunk=32)
    got = L._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          pa, causal=causal, q_chunk=16, k_chunk=32)
    _close(got.numpy(), want)


@pytest.mark.parametrize("batched", [True, False])
def test_rope_matches_jax(batched):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 12, 3, 32).astype(np.float32)
    pos = (np.arange(12)[None, :] + np.array([[0], [5]])) if batched else np.arange(12)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), 32, 10000.0)
    pc, ps = L.rope_cos_sin(torch.from_numpy(pos), 32, 10000.0)
    _close(pc.numpy(), jc)
    _close(ps.numpy(), js)
    _close(L.apply_rope(torch.from_numpy(x), pc, ps).numpy(),
           JL.apply_rope(jnp.asarray(x), jc, js))


@pytest.mark.parametrize("plus_one", [False, True])
def test_norms_match_jax(plus_one):
    rng = np.random.RandomState(9)
    x = (3 * rng.randn(2, 5, 48)).astype(np.float32)
    w = rng.randn(48).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    _close(cm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), plus_one=plus_one).numpy(),
           jcm.rms_norm(jnp.asarray(x), jnp.asarray(w), plus_one=plus_one))
    _close(cm.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy(),
           jcm.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(mlp_type):
    rng = np.random.RandomState(13)
    d, ff = 32, 80
    names = (["wi_gate", "wi_up"] if mlp_type != "gelu" else ["wi"]) + ["wo"]
    p = {n: (rng.randn(*((ff, d) if n == "wo" else (d, ff))) / 6).astype(np.float32)
         for n in names}
    if mlp_type == "gelu":
        p["bi"] = rng.randn(ff).astype(np.float32)
        p["bo"] = rng.randn(d).astype(np.float32)
    x = rng.randn(2, 7, d).astype(np.float32)
    want = JL.apply_mlp({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), mlp_type)
    got = L.apply_mlp({n: torch.from_numpy(a) for n, a in p.items()},
                      torch.from_numpy(x), mlp_type)
    _close(got.numpy(), want)
