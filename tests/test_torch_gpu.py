"""Tests of the port that need a CUDA card (marker ``gpu``; they skip on a
machine without one).  Run them on the card with
``python -m pytest -q -m gpu tests/test_torch_gpu.py``."""

import dataclasses

import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch import dist
from repro_torch.core import decomposition as dec
from repro_torch.core import transpose as tr
from repro_torch.configs import get_config
from repro_torch.kernels import attention, fft_mxu, fft_radix2, ref, ring_rdma
from repro_torch.models import transformer as T
from repro_torch.solvers import make_solver
from repro_torch.solvers.base import observables_rel_err

pytestmark = pytest.mark.gpu

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    """The plain versions' products go through cuBLAS: keep TF32 out of
    them for the test, and restore the setting after it."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


# every N the radix-2 row engine instantiates (log2 N 1..13 in f64, 1..14
# in f32: the wrappers' shared-memory limit), each with one row and with an
# odd number of rows (not a multiple of the rows a block); plus N=512 at 300
# rows, as before
RADIX2_CASES = [(1 << log2n, rows, dtype)
                for dtype in (torch.float64, torch.float32)
                for log2n in range(1, fft_radix2.max_n(dtype).bit_length())
                for rows in (1, (1 << 16 >> log2n) + 3)] + \
    [(512, 300, torch.float64), (512, 300, torch.float32)]


@pytest.mark.parametrize("n,rows,dtype", RADIX2_CASES)
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_matches_plain_version(cuda, n, rows, dtype, inverse):
    g = torch.Generator(device=cuda).manual_seed(n + rows)
    xr = torch.randn(rows, n, dtype=dtype, device=cuda, generator=g)
    xi = torch.randn(rows, n, dtype=dtype, device=cuda, generator=g)
    before = fft_radix2.launches
    kr, ki = fft_radix2.fft1d_radix2(xr, xi, inverse=inverse)
    assert fft_radix2.launches == before + 1
    pr, pi = (ref.ifft_dif_planar if inverse else ref.fft_dif_planar)(xr, xi)
    torch.cuda.synchronize()
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    err = max((kr - pr).abs().max().item(), (ki - pi).abs().max().item())
    assert err <= TOL[dtype] * scale


def test_kernel_refuses_what_it_cannot_run(cuda):
    x = torch.zeros(2, 16384, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="shared"):
        fft_radix2.fft1d_radix2(x, x)
    y = torch.zeros(4, 8, dtype=torch.float64, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        fft_radix2.fft1d_radix2(y, y)


@pytest.mark.parametrize("n,rows", [(2, 64), (4, 64), (16, 37), (512, 300), (8192, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("inverse", [False, True])
def test_mxu_kernel_matches_plain_version(cuda, no_tf32, n, rows, dtype, inverse):
    g = torch.Generator(device=cuda).manual_seed(n + rows)
    xr = torch.randn(rows, n, dtype=dtype, device=cuda, generator=g)
    xi = torch.randn(rows, n, dtype=dtype, device=cuda, generator=g)
    before = fft_mxu.launches
    kr, ki = fft_mxu.fft1d_mxu(xr, xi, inverse=inverse)
    assert fft_mxu.launches == before + 1
    pr, pi = fft_mxu.four_step_planar(xr, xi, inverse=inverse)
    torch.cuda.synchronize()
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    err = max((kr - pr).abs().max().item(), (ki - pi).abs().max().item())
    assert err <= TOL[dtype] * scale


def test_mxu_kernel_refuses_what_it_cannot_run(cuda):
    x = torch.zeros(2, 16384, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="N <= 8192"):
        fft_mxu.fft1d_mxu(x, x)
    y = torch.zeros(4, 8, dtype=torch.float64, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        fft_mxu.fft1d_mxu(y, y)
    z = torch.zeros(4, 1, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="power of two >= 2"):
        fft_mxu.fft1d_mxu(z, z)


@pytest.mark.parametrize("case", ["heat", "poisson", "nls", "navier_stokes"])
def test_solver_on_card_matches_cpu(cuda, case):
    grid = dec.PencilGrid.from_mesh(1, 1)
    cfg = {"backend": "pallas"}
    calls = ref.calls
    _, gpu_hist = make_solver(case, grid, 16, device=cuda, plan_cfg=cfg).run(2)
    assert ref.calls == calls  # the card path never reaches the plain version
    _, cpu_hist = make_solver(case, grid, 16, device="cpu", plan_cfg=cfg).run(2)
    for a, b in zip(gpu_hist, cpu_hist):
        assert observables_rel_err(a, b) <= 1e-10


def test_mxu_solver_on_card_matches_cpu(cuda):
    grid = dec.PencilGrid.from_mesh(1, 1)
    cfg = {"backend": "mxu", "r2c_packed": True}
    calls, plain, launches = ref.calls, fft_mxu.plain_calls, fft_mxu.launches
    _, gpu_hist = make_solver("heat", grid, 16, device=cuda, plan_cfg=cfg).run(2)
    # the card path launches the kernel and never reaches a plain version
    assert (ref.calls, fft_mxu.plain_calls) == (calls, plain)
    assert fft_mxu.launches > launches
    _, cpu_hist = make_solver("heat", grid, 16, device="cpu", plan_cfg=cfg).run(2)
    for a, b in zip(gpu_hist, cpu_hist):
        assert observables_rel_err(a, b) <= 1e-10


@pytest.mark.parametrize("n,rows,dtype", RADIX2_CASES)
@pytest.mark.parametrize("mode", ["forward", "inverse", "roundtrip"])
def test_ring_payload_matches_plain_version(cuda, n, rows, dtype, mode):
    g = torch.Generator(device=cuda).manual_seed(n + rows)
    xr, xi, dr, di = (torch.randn(rows, n, dtype=dtype, device=cuda, generator=g)
                      for _ in range(4))
    diag = (dr, di) if mode == "roundtrip" else None
    before = ring_rdma.payload_launches
    kr, ki = ring_rdma.ring_payload(xr, xi, diag=diag, inverse=mode == "inverse")
    assert ring_rdma.payload_launches == before + 1
    twr, twi = fft_radix2.twiddles(n, dtype, cuda)
    pr, pi = ring_rdma.payload_plain(xr, xi, twr, twi, diag, mode == "inverse")
    torch.cuda.synchronize()
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    err = max((kr - pr).abs().max().item(), (ki - pi).abs().max().item())
    assert err <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ring_send_and_land_are_bit_exact(cuda, dtype):
    """Take and place against plain indexing; the "peer" slot is a second
    buffer of this process."""
    g = torch.Generator(device=cuda).manual_seed(7)
    p = 4
    xs = [torch.randn(6, 5, 16, dtype=dtype, device=cuda, generator=g)
          for _ in range(2)]
    slots = [torch.empty(6, 5, 4, dtype=dtype, device=cuda) for _ in range(2)]
    before = ring_rdma.send_launches
    ring_rdma.ring_send(xs, 2, p, 2, slots)
    assert ring_rdma.send_launches == before + 1
    for x, s in zip(xs, slots):
        assert torch.equal(s, x[..., 8:12])
    outs = [torch.zeros(24, 5, 4, dtype=dtype, device=cuda) for _ in range(2)]
    before = ring_rdma.land_launches
    ring_rdma.ring_land(slots, outs, 1, p, 0)
    ring_rdma.ring_land([x[..., 0:4] for x in xs], outs, 3, p, 0)  # strided
    assert ring_rdma.land_launches == before + 2
    for o, s, x in zip(outs, slots, xs):
        assert torch.equal(o[6:12], s) and torch.equal(o[18:24], x[..., 0:4])


def _ipc_vs_gloo(ctx):
    """Every schedule on the peer-mapped wire and on the gloo wire, twice
    with different data (the second exchange reuses the landing slots)."""
    dev = ctx.device
    ipc, gloo = ctx.wire("u", dev), ctx.wire("u", "cpu")
    same = []
    for seed in (1, 2):
        g = torch.Generator().manual_seed(100 * seed + ctx.rank)
        arrs = [torch.randn(4, 3, 8, dtype=torch.float64, generator=g)
                for _ in range(2)]
        for fn in (tr.ring_exchange, tr.ring_exchange_bidi):
            got, _ = fn([a.to(dev) for a in arrs], ipc, split_axis=2,
                        concat_axis=0)
            want, _ = fn(arrs, gloo, split_axis=2, concat_axis=0)
            same += [torch.equal(a.cpu(), b) for a, b in zip(got, want)]
        got = ipc.all_to_all([a.to(dev) for a in arrs], split_axis=0,
                             concat_axis=2)
        want = gloo.all_to_all(arrs, split_axis=0, concat_axis=2)
        same += [torch.equal(a.cpu(), b) for a, b in zip(got, want)]
    torch.cuda.synchronize(dev)
    return all(same), ipc.exchanges, ipc.rounds


def test_ipc_exchange_on_one_card_matches_gloo(cuda):
    before = ring_rdma.send_launches
    results = dist.run_ranks(_ipc_vs_gloo, 2, 1, device="cuda")
    assert ring_rdma.send_launches == before  # the ranks launched, not us
    for ok, exchanges, rounds in results:
        # per seed: ring (1 round), bidi (1 round), switched (1 round)
        assert ok and exchanges == 6 and rounds == 6


FLASH_TOL_F32 = 2e-5  # bf16: attention.bf16_gap


@pytest.mark.parametrize("s", [1, 17, 64, 129, 2048])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 3, 8])
@pytest.mark.parametrize("d", [20, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_matches_plain_version(cuda, no_tf32, dtype, d, group, causal, s):
    # causal runs S == T (the mask is aligned at the top left); full runs
    # a ragged T beside S
    t = s if causal else s + 13
    hkv = 2
    g = torch.Generator(device=cuda).manual_seed(d + group + s)
    q = torch.randn(1, s, hkv * group, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(1, t, hkv, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(1, t, hkv, d, device=cuda, generator=g).to(dtype)
    before, pads = attention.launches, attention.pad_copies
    got = attention.flash_attention(q, k, v, causal=causal)
    assert attention.launches == before + 1
    # only bf16 operands that TMA cannot describe (D=20) are copied
    assert attention.pad_copies == pads + (dtype == torch.bfloat16 and d % 8 != 0)
    want = attention.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.bfloat16:
        gap = attention.bf16_gap(got, want)
        assert gap["ok"], gap
    else:
        torch.testing.assert_close(got, want, rtol=FLASH_TOL_F32, atol=FLASH_TOL_F32)


def test_flash_kernel_reads_strided_inputs(cuda):
    # q, k, v as views of one fused (B, S, H + 2·Hkv, D) projection
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn(2, 40, 6 + 2 * 2, 64, device=cuda, generator=g).bfloat16()
    q, k, v = qkv[:, :, :6], qkv[:, :, 6:8], qkv[:, :, 8:]
    got = attention.flash_attention(q, k, v, causal=True)
    want = attention.flash_attention_plain(q.contiguous(), k.contiguous(),
                                           v.contiguous(), causal=True)
    torch.cuda.synchronize()
    gap = attention.bf16_gap(got, want)
    assert gap["ok"], gap
    with pytest.raises(ValueError, match="contiguous head dimension"):
        attention.flash_attention(q.transpose(1, 3), k.transpose(1, 3),
                                  v.transpose(1, 3))


def _misaligned(x):
    """x as a view one element into a wider buffer: a head base that is not
    16-byte aligned, strides that are."""
    d = x.shape[-1]
    buf = torch.zeros(x.shape[:3] + (d + 8,), dtype=x.dtype, device=x.device)
    buf[..., 1:d + 1] = x
    return buf[..., 1:d + 1]


@pytest.mark.parametrize("case", ["d20", "misaligned"])
def test_flash_kernel_pads_what_tma_cannot_read(cuda, case):
    d = 20 if case == "d20" else 64
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn(2, 150, hk, d, device=cuda, generator=g).bfloat16()
               for hk in (6, 2, 2))
    if case == "misaligned":
        q, k, v = (_misaligned(x) for x in (q, k, v))
        assert q.data_ptr() % 16
    pads, launches = attention.pad_copies, attention.launches
    got = attention.flash_attention(q, k, v, causal=True)
    assert (attention.pad_copies, attention.launches) == (pads + 1, launches + 1)
    want = attention.flash_attention_plain(q.contiguous(), k.contiguous(),
                                           v.contiguous(), causal=True)
    torch.cuda.synchronize()
    gap = attention.bf16_gap(got, want)
    assert gap["ok"], gap


def test_lm_prefill_on_card_makes_no_pad_copy(cuda):
    cfg = dataclasses.replace(get_config("smollm-360m", smoke=True), n_heads=4,
                              n_kv_heads=2, d_model=256, compute_dtype="bfloat16")
    tokens = torch.randint(0, cfg.vocab, (2, 140), generator=torch.Generator().manual_seed(1))
    model = T.init_model(cfg, seed=0, device=cuda)
    launches, pads = attention.launches, attention.pad_copies
    logits, _ = T.prefill(cfg, T.RunCfg(), model, {"tokens": tokens.to(cuda)}, t_max=144)
    assert attention.launches == launches + cfg.n_layers
    assert attention.pad_copies == pads  # D = 64: every operand read in place
    assert torch.isfinite(logits).all()


def test_lm_prefill_on_card_launches_the_kernel_and_matches_cpu(cuda):
    cfg = get_config("smollm-360m", smoke=True)  # f32
    run = T.RunCfg()
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(0))
    model = T.init_model(cfg, seed=0, device="cpu")
    want, cpu_cache = T.prefill(cfg, run, model, {"tokens": tokens}, t_max=28)
    model.to(cuda)
    launches, plain = attention.launches, attention.plain_calls
    got, cache = T.prefill(cfg, run, model, {"tokens": tokens.to(cuda)}, t_max=28)
    assert attention.launches == launches + cfg.n_layers
    assert attention.plain_calls == plain
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    logits, cache = T.decode_step(cfg, run, model, cache, got[:, -1].argmax(-1)[:, None])
    assert cache["len"] == 25 and torch.isfinite(logits).all()
