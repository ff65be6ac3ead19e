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
from repro_torch.kernels import attention, fft_mxu, fft_radix2, ref, ring_rdma, wkv
from repro_torch.kernels import selective_scan as SS
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


# every N of the four-step kernel (log2 N 1..13), each with one row and
# with an odd number of rows (a ragged last set; at N = 64 and 128 a row
# without its pair); plus N = 512 at 300 rows, as before
MXU_CASES = [(1 << log2n, rows) for log2n in range(1, 14)
             for rows in (1, (1 << 16 >> log2n) + 3)] + [(512, 300)]


@pytest.mark.parametrize("n,rows", MXU_CASES)
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
    # the bulk copies of the f64 tensor-core path need 16-byte aligned rows
    w = torch.zeros(4 * 512 + 1, dtype=torch.float64, device=cuda)[1:].view(4, 512)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fft_mxu.fft1d_mxu(w, w)


def test_mma_probe_measures_every_shape(cuda):
    rates = fft_mxu.mma_rates(cuda, chains=(4,), iters=256)
    assert [r["shape"] for r in rates] == [s[0] for s in fft_mxu.MMA_SHAPES]
    assert all(r["tflops"] > 0 for r in rates)


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


@pytest.mark.parametrize("n", [16, 512])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", ["forward", "inverse", "roundtrip"])
def test_ring_payload_lanes_match_plain_version(cuda, n, dtype, mode):
    """The serving batch's payload: B=3 lanes of a slab narrowed out of a
    lane stack (read in place, a lane stride between lanes), a multiplier
    shared by every lane, a lane-strided output.  Held against the plain
    version, and each lane bitwise a solo launch on that lane's rows."""
    g = torch.Generator(device=cuda).manual_seed(n)
    stack = [torch.randn(3, 8, 5, n, dtype=dtype, device=cuda, generator=g)
             for _ in range(2)]
    xr, xi = (t[:, 2:6] for t in stack)             # (3, 4, 5, n), strided
    assert not xr.is_contiguous()
    diag = tuple(torch.randn(4, 5, n, dtype=dtype, device=cuda, generator=g)
                 for _ in range(2)) if mode == "roundtrip" else None
    outs = [torch.full((3, 6, 5, n), 7.0, dtype=dtype, device=cuda)
            for _ in range(2)]
    out = tuple(o[:, 1:5] for o in outs)
    before = ring_rdma.payload_launches
    kr, ki = ring_rdma.ring_payload(xr, xi, diag=diag, inverse=mode == "inverse",
                                    out=out)
    assert ring_rdma.payload_launches == before + 1
    assert kr.data_ptr() == out[0].data_ptr()
    twr, twi = fft_radix2.twiddles(n, dtype, cuda)
    pr, pi = ring_rdma.payload_plain(xr, xi, twr, twi, diag, mode == "inverse")
    torch.cuda.synchronize()
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    err = max((kr - pr).abs().max().item(), (ki - pi).abs().max().item())
    assert err <= TOL[dtype] * scale
    for o in outs:  # nothing outside the output's lanes was written
        assert bool((o[:, 0] == 7.0).all()) and bool((o[:, 5] == 7.0).all())
    for b in range(3):
        sr, si = ring_rdma.ring_payload(xr[b].contiguous(), xi[b].contiguous(),
                                        diag=diag, inverse=mode == "inverse")
        assert torch.equal(sr, kr[b]) and torch.equal(si, ki[b])


@pytest.mark.parametrize("backend", ["pallas", "mxu", "jnp"])
@pytest.mark.parametrize("case", ["heat", "navier_stokes"])
def test_batched_step_on_card_is_bitwise_per_lane(cuda, case, backend):
    """A batch of 3 lanes through one step on the card: each lane's fields
    and observables bitwise its solo step's, with the kernel launches of
    one solo step and no plain version."""
    from repro_torch.serving import scaled_initial_fields
    from repro_torch.solvers import SolverState

    grid = dec.PencilGrid.from_mesh(1, 1)
    s = make_solver(case, grid, 32, device=cuda, plan_cfg={"backend": backend})
    lanes = [scaled_initial_fields(s, 1.0 + 0.25 * b) for b in range(3)]
    stack = tuple(torch.stack(xs) for xs in zip(*lanes))

    def counts():
        return (fft_radix2.launches, fft_mxu.launches, ref.calls,
                fft_mxu.plain_calls)
    c0 = counts()
    stack = s.batched_step(stack)
    c1 = counts()
    batched_obs = s.batched_observables(stack)
    solo = [s.step(SolverState(fields=lane)) for lane in lanes]
    c2 = counts()
    for b, st in enumerate(solo):
        assert all(torch.equal(f[b], g) for f, g in zip(stack, st.fields))
        o = s.observables(st)
        assert all(batched_obs[k][b] == o[k] for k in batched_obs)
    batch = [a - b for a, b in zip(c1, c0)]
    per_solo = [(a - b) / 3 for a, b in zip(c2, c1)]
    assert batch == per_solo and batch[2:] == [0, 0]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("split_axis", [0, 1, 2])
@pytest.mark.parametrize("misaligned", [False, True])
def test_ring_copies_are_bit_exact_on_every_layout(cuda, dtype, p, split_axis,
                                                   misaligned):
    """The layouts of tests/test_torch_copy_plan.py on the card: a send along
    each split axis, a landed slot and the own block along each concat axis,
    p = 2 and 4, bases 16-byte aligned or one element off; the width the
    plan chose counted per launch."""
    g = torch.Generator(device=cuda).manual_seed(split_axis + 10 * p)
    shape = (8, 12, 16)
    n = 8 * 12 * 16
    xs = [torch.randn(n + 1, dtype=dtype, device=cuda, generator=g)
          [int(misaligned):n + int(misaligned)].view(shape) for _ in range(2)]
    blk = tr.block(xs[0], p - 1, p, split_axis).shape
    slots = [torch.empty(blk, dtype=dtype, device=cuda) for _ in range(2)]
    widths = dict(ring_rdma.copy_widths)
    ring_rdma.ring_send(xs, p - 1, p, split_axis, slots)
    torch.cuda.synchronize()
    for x, s in zip(xs, slots):
        assert torch.equal(s, tr.block(x, p - 1, p, split_axis))
    want = 8 if misaligned and dtype == torch.float64 else (4 if misaligned else 16)
    assert ring_rdma.copy_widths[want] == widths[want] + 1
    for concat in range(3):
        outs = [torch.zeros(tr.merged_shape(shape, p, split_axis, concat),
                            dtype=dtype, device=cuda) for _ in range(2)]
        ring_rdma.ring_land(slots, outs, 1, p, concat)
        ring_rdma.ring_land([tr.block(x, 0, p, split_axis) for x in xs], outs, 0, p,
                            concat)
        torch.cuda.synchronize()
        for o, s, x in zip(outs, slots, xs):
            assert torch.equal(tr.block(o, 1, p, concat), s)
            assert torch.equal(tr.block(o, 0, p, concat), tr.block(x, 0, p, split_axis))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("which", ["fold_xy", "unfold_xy"])
def test_staged_exchange_copies_are_bit_exact(cuda, dtype, which):
    """The copies of a staged exchange over two mesh axes of 2 ranks (a
    3-axis mesh's u fold and unfold) on the card, each rank's view made in
    one process (tests/test_torch_copy_plan.py::staged_layouts): the result
    is the flat tiled all-to-all's, bit for bit, and the plan's widths are
    those pinned on the CPU."""
    from test_torch_copy_plan import STAGED, STAGED_WIDTHS, staged_layouts

    _, _, split, concat = STAGED[which]
    for me in ((1, 0), (0, 0), (0, 1), (1, 1)):
        widths, sends = dict(ring_rdma.copy_widths), ring_rdma.send_launches
        _, x, got = staged_layouts(dtype, which, me, device=cuda)
        torch.cuda.synchronize()
        assert ring_rdma.send_launches == sends + 2  # one a stage
        want = tr.merge_blocks(tr.stack_blocks(x, 4, split), 4, concat)
        assert torch.equal(got, want), me
        if me == (1, 0):
            launched = sorted(w for w in ring_rdma.COPY_WIDTHS
                              for _ in range(ring_rdma.copy_widths[w] - widths[w]))
            assert launched == sorted(STAGED_WIDTHS[(which, dtype)])


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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_under_autograd_reaches_q_k_v(cuda, no_tf32, dtype, causal):
    # the kernel's output is attached to q, k and v; the backward is the
    # direct attention's gradient (in f32: the f32 plain version's autograd)
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(2, 150, 6, 64, device=cuda, generator=g).to(dtype).requires_grad_()
    k = torch.randn(2, 150, 2, 64, device=cuda, generator=g).to(dtype).requires_grad_()
    v = torch.randn(2, 150, 2, 64, device=cuda, generator=g).to(dtype).requires_grad_()
    do = torch.randn(2, 150, 6, 64, device=cuda, generator=g).to(dtype)
    launches, plain = attention.launches, attention.plain_calls
    out = attention.flash_attention(q, k, v, causal=causal)
    assert out.grad_fn is not None and attention.launches == launches + 1
    out.backward(do)
    assert attention.plain_calls == plain
    ref = [x.detach().float().requires_grad_() for x in (q, k, v)]
    attention.flash_attention_plain(*ref, causal=causal).backward(do.float())
    for got, want in zip((q, k, v), ref):
        assert got.grad.dtype == dtype and bool(got.grad.abs().max() > 0)
        scale = want.grad.abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        assert (got.grad.float() - want.grad).abs().max().item() <= tol * scale


def test_train_step_on_card_launches_the_kernel_and_matches_cpu(cuda, no_tf32):
    cfg = dataclasses.replace(get_config("smollm-360m", smoke=True), remat=True)  # f32
    from repro_torch.optim import adamw
    from repro_torch.training.train_loop import TrainCfg, make_train_step

    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(2))
    losses = {}
    for dev in ("cpu", cuda):
        model = T.init_model(cfg, seed=0, device="cpu").to(dev)
        acfg = adamw.AdamWConfig(warmup_steps=1, total_steps=3)
        state = adamw.init(acfg, dict(model.named_parameters()))
        step = make_train_step(cfg, T.RunCfg(), TrainCfg(adamw=acfg))
        launches = attention.launches
        losses[str(dev)] = [float(step(model, state, {"tokens": tokens.to(dev)})[0])
                            for _ in range(3)]
        if dev != "cpu":
            assert attention.launches == launches + 3 * T.block_forwards(cfg, T.RunCfg())
    assert losses["cpu"] == pytest.approx(losses["cuda"], abs=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_moe_index_dispatch_matches_the_one_hot_version_on_card(cuda, no_tf32, dtype, tol):
    # qwen3-moe's widths (128 experts, top-8, d 2048, expert d_ff 768) at
    # 512 tokens and capacity factor 1.25; the routing skewed so that pairs drop
    from repro_torch.models import moe as MOE

    m = MOE.MoEDims(d_model=2048, n_experts=128, top_k=8, d_ff_expert=768)
    g = torch.Generator(device=cuda).manual_seed(14)
    p = {"router": 0.02 * torch.randn(2048, 128, device=cuda, generator=g),
         "experts": {k: torch.randn(*s, device=cuda, generator=g) / s[1] ** 0.5
                     for k, s in (("wi_gate", (128, 2048, 768)),
                                  ("wi_up", (128, 2048, 768)),
                                  ("wo", (128, 768, 2048)))}}
    p = {"router": p["router"].to(dtype),
         "experts": {k: v.to(dtype) for k, v in p["experts"].items()}}
    x = (torch.randn(2, 256, 2048, device=cuda, generator=g) + 0.5).to(dtype)
    got, share = MOE.count_drops(lambda: MOE.apply_moe(p, m, x))
    want = MOE.apply_moe_plain(p, m, x)
    assert share > 0
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= tol


def test_moe_top_k_on_card_takes_the_lower_index_first(cuda):
    # bf16-rounded router logits tie often among 128 experts: the card's
    # order must be the CPU's (jax.lax.top_k's, checked there)
    from repro_torch.models import moe as MOE

    g = torch.Generator().manual_seed(15)
    probs = torch.softmax((torch.randn(4096, 128, generator=g) * 0.05)
                          .bfloat16().float(), dim=-1)
    v_cpu, i_cpu = MOE.top_k(probs, 8)
    v, i = MOE.top_k(probs.to(cuda), 8)
    assert (probs[:, :, None] == probs[:, None, :]).sum() > probs.numel()  # ties
    assert torch.equal(i.cpu(), i_cpu) and torch.equal(v.cpu(), v_cpu)
    e = torch.randint(0, 128, (4096 * 8,), generator=g)
    assert torch.equal(MOE.arrival(e.to(cuda), 128).cpu(), MOE.arrival(e, 128))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_at_mla_head_width(cuda, no_tf32, dtype):
    # deepseek-v2-lite's decompressed MLA prefill: 16 heads on 16 at D=192
    # (nope 128 + rope 64; v zero-padded to 192), the bf16 tiles at DP=256
    g = torch.Generator(device=cuda).manual_seed(192)
    q, k, v = (torch.randn(2, 512, 16, 192, device=cuda, generator=g).to(dtype)
               for _ in range(3))
    before, pads = attention.launches, attention.pad_copies
    got = attention.flash_attention(q, k, v, causal=True)
    assert (attention.launches, attention.pad_copies) == (before + 1, pads)
    want = attention.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.bfloat16:
        gap = attention.bf16_gap(got, want)
        assert gap["ok"], gap
    else:
        torch.testing.assert_close(got, want, rtol=FLASH_TOL_F32, atol=FLASH_TOL_F32)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_mla_decompressed_on_kernel_matches_the_latent_form(cuda, no_tf32, dtype, tol):
    # one MLA layer at deepseek-v2-lite's widths (d 2048, 16 heads, kv_lora
    # 512, nope 128, rope 64, v 128), B=2, S=512: the main path's form on
    # the kernel against the reference's latent form in plain torch
    from repro_torch.models import mla as MLA
    from repro_torch.models import common as cm

    cfg = get_config("deepseek-v2-lite-16b")
    m = T.mla_dims(cfg)
    layer = MLA.MLA(cm.Initializer(torch.Generator(device=cuda).manual_seed(3),
                                   torch.float32, cuda), m)
    p = {n: w.to(dtype) for n, w in layer.named_parameters()}
    x = torch.randn(2, 512, cfg.d_model, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(4)).to(dtype)
    pos = torch.arange(512, device=cuda)[None].expand(2, 512)
    launches, plain, pads = attention.launches, attention.plain_calls, attention.pad_copies
    got, (c, k) = MLA.apply_mla(p, m, x, pos)
    assert (attention.launches, attention.plain_calls, attention.pad_copies) == \
        (launches + 1, plain, pads)
    want, (c2, k2) = MLA.apply_mla_latent(p, m, x, pos)
    assert torch.equal(c, c2) and torch.equal(k, k2)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert bool(torch.isfinite(got).all()) and float(err) <= tol


def test_mla_model_on_card_launches_the_kernel_once_a_layer(cuda):
    # deepseek-v2-lite at full width cut to 2 layers (the dense first block
    # and one MoE block), bf16: a prefill launches the kernel once a layer
    # at D=192, reads every operand in place, and decodes over the cache
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"), n_layers=2)
    model = T.init_model(cfg, seed=0, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 256), generator=torch.Generator().manual_seed(5))
    launches, plain, pads = attention.launches, attention.plain_calls, attention.pad_copies
    logits, cache = T.prefill(cfg, T.RunCfg(), model, {"tokens": tokens.to(cuda)}, t_max=260)
    assert (attention.launches, attention.plain_calls, attention.pad_copies) == \
        (launches + 2, plain, pads)
    assert tuple(cache["k"].shape) == (2, 2, 260, 512)
    assert tuple(cache["v"].shape) == (2, 2, 260, 64)
    logits, cache = T.decode_step(cfg, T.RunCfg(), model, cache,
                                  logits[:, -1].argmax(-1)[:, None])
    assert cache["len"] == 257 and torch.isfinite(logits).all()


def test_int8_cache_on_card_tracks_the_float_cache(cuda):
    # smollm-360m's smoke config in bf16 on the card: a prefill (the kernel
    # once a layer) into an int8 cache, then 8 decode steps fed the float
    # cache's tokens; the logits within the reference's own 0.08·max|logit|
    # of the float cache's, top-1 agreeing on ≥ 7 of 8 steps per row
    cfg = dataclasses.replace(get_config("smollm-360m", smoke=True), compute_dtype="bfloat16")
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    model = T.init_model(cfg, seed=7, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=torch.Generator().manual_seed(7))
    run = T.RunCfg()
    launches = attention.launches
    lo, cache = T.prefill(cfg, run, model, {"tokens": tokens.to(cuda)}, t_max=72)
    lq, cacheq = T.prefill(cfgq, run, model, {"tokens": tokens.to(cuda)}, t_max=72)
    assert attention.launches == launches + 2 * cfg.n_layers
    assert cacheq["k"].dtype == torch.int8 and cacheq["k_scale"].dtype == torch.float32
    agree = 0
    for step in range(8):
        err = (lq.float() - lo.float()).abs().max() / lo.float().abs().max()
        assert float(err) < 0.08, (step, float(err))
        agree += int((lq[:, -1].argmax(-1) == lo[:, -1].argmax(-1)).sum())
        tok = lo[:, -1].argmax(-1)[:, None]
        lo, cache = T.decode_step(cfg, run, model, cache, tok)
        lq, cacheq = T.decode_step(cfgq, run, model, cacheq, tok)
    assert agree >= 7 * 2 and cacheq["len"] == 72


def _wkv_inputs(cuda, b, s, h, k, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    r, kk, v = (torch.randn(b, s, h, k, device=cuda, generator=g).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(b, s, h, k, device=cuda, generator=g) - 1))
    u = torch.randn(h, k, device=cuda, generator=g) * 0.5
    state = torch.randn(b, h, k, k, device=cuda, generator=g) * 0.3
    return r, kk, v, w, u, state


@pytest.mark.parametrize("s", [1, 37, 300])
@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wkv6_kernel_matches_plain_version(cuda, no_tf32, dtype, k, s):
    # one step, an odd count (a ragged last chunk of 32), several chunks;
    # from a nonzero state: y and the final state within 1e-5 of the max
    args = _wkv_inputs(cuda, 3, s, 5, k, dtype, seed=s + k)
    launches = wkv.launches
    y, st = wkv.wkv6(*args)
    assert wkv.launches == launches + 1
    yp, sp = wkv.wkv6_plain(*args)
    torch.cuda.synchronize()
    assert y.dtype == st.dtype == torch.float32
    assert float((y - yp).abs().max()) <= 1e-5 * float(yp.abs().max())
    assert float((st - sp).abs().max()) <= 1e-5 * float(sp.abs().max())


def test_wkv6_kernel_carries_its_state_bitwise(cuda):
    # the recurrence over S steps equals its two halves with the state
    # carried, bit for bit (the same arithmetic step by step)
    r, k, v, w, u, state = _wkv_inputs(cuda, 2, 96, 4, 64, torch.bfloat16, seed=3)
    y, st = wkv.wkv6(r, k, v, w, u, state)
    y1, s1 = wkv.wkv6(*(x[:, :41].contiguous() for x in (r, k, v, w)), u, state)
    y2, s2 = wkv.wkv6(*(x[:, 41:].contiguous() for x in (r, k, v, w)), u, s1)
    assert torch.equal(y, torch.cat([y1, y2], 1)) and torch.equal(st, s2)


def test_wkv6_kernel_refuses_other_head_sizes_and_autograd(cuda):
    # other head sizes are refused; under autograd the forward and the
    # backward each launch their kernel once, and the gradients reach r
    r, k, v, w, u, state = _wkv_inputs(cuda, 1, 4, 2, 32, torch.float32, seed=1)
    with pytest.raises(ValueError, match="head size 32"):
        wkv.wkv6(r, k, v, w, u, state)
    r, k, v, w, u, state = _wkv_inputs(cuda, 1, 4, 2, 64, torch.float32, seed=1)
    counts = (wkv.launches, wkv.bwd_launches, wkv.plain_calls, wkv.plain_bwd_calls)
    y, _ = wkv.wkv6(r.requires_grad_(), k, v, w, u, state)
    y.sum().backward()
    assert (wkv.launches, wkv.bwd_launches, wkv.plain_calls, wkv.plain_bwd_calls) == \
        (counts[0] + 1, counts[1] + 1, counts[2], counts[3])
    assert r.grad is not None and bool(r.grad.abs().max() > 0)


def _wkv_grad_inputs(cuda, b, s, h, k, dtype, seed):
    """The forward's inputs, its checkpoints (the kernel's), dy and dS."""
    args = _wkv_inputs(cuda, b, s, h, k, dtype, seed)
    _, _, ck = wkv._kernel(*args, checkpoints=True)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    dy = torch.randn(b, s, h, k, device=cuda, generator=g)
    ds = torch.randn(b, h, k, k, device=cuda, generator=g)
    return args[:5], ck, dy, ds


@pytest.mark.parametrize("s", [1, 37, 300])
@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wkv6_bwd_kernel_matches_plain_version(cuda, no_tf32, dtype, k, s):
    # one step, a ragged last chunk of 16, many chunks; from a nonzero
    # state with a nonzero dS: each gradient within 1e-5 of its max
    ins, ck, dy, ds = _wkv_grad_inputs(cuda, 3, s, 5, k, dtype, seed=s + k)
    launches = wkv.bwd_launches
    got = wkv.wkv6_bwd(*ins, ck, dy, ds)
    assert wkv.bwd_launches == launches + 1
    want = wkv.wkv6_backward_plain(*ins, ck, dy, ds)
    torch.cuda.synchronize()
    for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), name


def test_wkv6_bwd_kernel_gives_the_same_bits_twice(cuda):
    ins, ck, dy, ds = _wkv_grad_inputs(cuda, 2, 70, 4, 64, torch.bfloat16, seed=5)
    one, two = wkv.wkv6_bwd(*ins, ck, dy, ds), wkv.wkv6_bwd(*ins, ck, dy, ds)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("k", [16, 64])
def test_wkv6_kernel_with_checkpoints_gives_the_same_bits(cuda, k):
    # keeping the states changes no bit of y or the final state; the
    # states kept are the plain loop's within 1e-5
    args = _wkv_inputs(cuda, 2, 75, 4, k, torch.bfloat16, seed=6)
    y, st = wkv.wkv6(*args)
    yc, sc, ck = wkv._kernel(*args, checkpoints=True)
    assert torch.equal(y, yc) and torch.equal(st, sc)
    assert torch.equal(ck[:, 0], args[5])
    _, _, cp = wkv.wkv6_plain(*args, checkpoints=True)
    assert float((ck - cp).abs().max()) <= 1e-5 * float(cp.abs().max())


def test_rwkv_training_step_on_card_launches_both_kernels(cuda, no_tf32):
    # rwkv6-3b's smoke config (K=16, f32) trained one step on the card: a
    # forward and a backward launch a layer, no plain call, the loss within
    # 1e-4 of the CPU's
    cfg = get_config("rwkv6-3b", smoke=True)
    from repro_torch.optim import adamw
    from repro_torch.training.train_loop import TrainCfg, make_train_step

    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(2))
    losses = {}
    for dev in ("cpu", cuda):
        model = T.init_model(cfg, seed=0, device="cpu").to(dev)
        acfg = adamw.AdamWConfig(warmup_steps=1, total_steps=2)
        state = adamw.init(acfg, dict(model.named_parameters()))
        step = make_train_step(cfg, T.RunCfg(), TrainCfg(adamw=acfg))
        counts = (wkv.launches, wkv.bwd_launches, wkv.plain_calls, wkv.plain_bwd_calls)
        losses[str(dev)] = [float(step(model, state, {"tokens": tokens.to(dev)})[0])
                            for _ in range(2)]
        if dev != "cpu":
            n = 2 * cfg.n_layers
            assert (wkv.launches, wkv.bwd_launches, wkv.plain_calls, wkv.plain_bwd_calls) \
                == (counts[0] + n, counts[1] + n, counts[2], counts[3])
    assert losses["cpu"] == pytest.approx(losses["cuda"], abs=1e-4)


def test_rwkv_model_on_card_launches_the_kernel_once_a_layer(cuda, no_tf32):
    # rwkv6-3b's smoke config (K=16) in f32 on the card: a prefill and each
    # decode step launch the kernel once a layer; the logits within 1e-4 of
    # the plain recurrence's run
    cfg = get_config("rwkv6-3b", smoke=True)
    model = T.init_model(cfg, seed=0, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(2))
    run, plain_run = T.RunCfg(), T.RunCfg(plain_wkv=True)
    launches, plain = wkv.launches, wkv.plain_calls
    lk, ck = T.prefill(cfg, run, model, {"tokens": tokens.to(cuda)})
    lk2, ck = T.decode_step(cfg, run, model, ck, lk[:, -1].argmax(-1)[:, None])
    assert (wkv.launches, wkv.plain_calls) == (launches + 2 * cfg.n_layers, plain)
    lp, cp = T.prefill(cfg, plain_run, model, {"tokens": tokens.to(cuda)})
    lp2, cp = T.decode_step(cfg, plain_run, model, cp, lk[:, -1].argmax(-1)[:, None])
    for a, b in ((lk, lp), (lk2, lp2), (ck["wkv"], cp["wkv"])):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _scan_inputs(cuda, b, s, di, ds, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn(b, s, di, device=cuda, generator=g) - 1)
    x = torch.randn(b, s, di, device=cuda, generator=g).to(dtype)
    bm, cm = (torch.randn(b, s, ds, device=cuda, generator=g) for _ in range(2))
    a_log = torch.randn(di, ds, device=cuda, generator=g) * 0.5
    d = torch.randn(di, device=cuda, generator=g)
    h0 = torch.randn(b, di, ds, device=cuda, generator=g) * 0.3
    return dt, x, bm, cm, a_log, d, h0


@pytest.mark.parametrize("s", [1, 37, 300])
@pytest.mark.parametrize("ds", [8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_selective_scan_kernel_matches_plain_version(cuda, no_tf32, dtype, ds, s):
    # one step, an odd count (a ragged last chunk of 64), several chunks;
    # d_inner 200 (a ragged last block of 128 channels) from a nonzero
    # state: y and the final state within 1e-5 of the max
    args = _scan_inputs(cuda, 3, s, 200, ds, dtype, seed=s + ds)
    launches, plain = SS.launches, SS.plain_calls
    y, h = SS.selective_scan(*args)
    assert (SS.launches, SS.plain_calls) == (launches + 1, plain)
    yp, hp = SS.selective_scan_plain(*args)
    torch.cuda.synchronize()
    assert y.dtype == h.dtype == torch.float32
    assert float((y - yp).abs().max()) <= 1e-5 * float(yp.abs().max())
    assert float((h - hp).abs().max()) <= 1e-5 * float(hp.abs().max())


def test_selective_scan_kernel_carries_its_state_bitwise(cuda):
    # the recurrence over S steps equals its two halves with the state
    # carried, bit for bit (the same arithmetic step by step)
    dt, x, bm, cm, a_log, d, h0 = _scan_inputs(cuda, 2, 150, 256, 16, torch.bfloat16, seed=3)
    y, h = SS.selective_scan(dt, x, bm, cm, a_log, d, h0)
    cut = [t[:, :41].contiguous() for t in (dt, x, bm, cm)]
    y1, h1 = SS.selective_scan(*cut, a_log, d, h0)
    y2, h2 = SS.selective_scan(*(t[:, 41:].contiguous() for t in (dt, x, bm, cm)), a_log, d, h1)
    assert torch.equal(y, torch.cat([y1, y2], 1)) and torch.equal(h, h2)


def test_selective_scan_kernel_refuses_other_state_sizes_and_autograd(cuda):
    # other state sizes are refused; under autograd the forward (with its
    # checkpoints) and the backward each launch their kernel once, and the
    # gradients reach dt
    args = _scan_inputs(cuda, 1, 4, 128, 4, torch.float32, seed=1)
    with pytest.raises(ValueError, match="d_state 4"):
        SS.selective_scan(*args)
    dt, *rest = _scan_inputs(cuda, 1, 40, 128, 16, torch.float32, seed=1)
    counts = (SS.launches, SS.bwd_launches, SS.plain_calls, SS.plain_bwd_calls)
    y, _ = SS.selective_scan(dt.requires_grad_(), *rest)
    y.sum().backward()
    assert (SS.launches, SS.bwd_launches, SS.plain_calls, SS.plain_bwd_calls) == \
        (counts[0] + 1, counts[1] + 1, counts[2], counts[3])
    assert dt.grad is not None and bool(dt.grad.abs().max() > 0)


def _scan_grad_inputs(cuda, b, s, di, ds, dtype, seed):
    """The forward's inputs, its checkpoints (the kernel's), dy and dS."""
    args = _scan_inputs(cuda, b, s, di, ds, dtype, seed)
    _, _, ck = SS._kernel(*args, checkpoints=True)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    dy = torch.randn(b, s, di, device=cuda, generator=g)
    dh = torch.randn(b, di, ds, device=cuda, generator=g)
    return args[:6], ck, dy, dh


@pytest.mark.parametrize("s", [1, 37, 512])
@pytest.mark.parametrize("ds", [8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_selective_scan_bwd_kernel_matches_plain_version(cuda, no_tf32, dtype, ds, s):
    # one step, a ragged last chunk of 16, many chunks; d_inner 200 (a
    # ragged last block of 64 channels) from a nonzero state with a nonzero
    # dS: each gradient within 1e-5 of its max
    ins, ck, dy, dh = _scan_grad_inputs(cuda, 3, s, 200, ds, dtype, seed=s + ds)
    launches = SS.bwd_launches
    got = SS.selective_scan_bwd(*ins, ck, dy, dh)
    assert SS.bwd_launches == launches + 1
    want = SS.selective_scan_backward_plain(*ins, ck, dy, dh)
    torch.cuda.synchronize()
    for name, a, b in zip(("d(dt)", "dx", "dB", "dC", "dA_log", "dD", "dh0"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), name


def test_selective_scan_bwd_kernel_gives_the_same_bits_twice(cuda):
    ins, ck, dy, dh = _scan_grad_inputs(cuda, 2, 70, 256, 16, torch.bfloat16, seed=5)
    one, two = SS.selective_scan_bwd(*ins, ck, dy, dh), SS.selective_scan_bwd(*ins, ck, dy, dh)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("ds", [8, 16])
def test_selective_scan_kernel_with_checkpoints_gives_the_same_bits(cuda, ds):
    # keeping the states changes no bit of y or the final state; the states
    # kept are the plain loop's within 1e-5
    args = _scan_inputs(cuda, 2, 75, 200, ds, torch.bfloat16, seed=6)
    y, h = SS.selective_scan(*args)
    yc, hc, ck = SS._kernel(*args, checkpoints=True)
    assert torch.equal(y, yc) and torch.equal(h, hc)
    assert torch.equal(ck[:, 0], args[6])
    _, _, cp = SS.selective_scan_plain(*args, checkpoints=True)
    assert float((ck - cp).abs().max()) <= 1e-5 * float(cp.abs().max())


def test_jamba_training_step_on_card_launches_both_kernels(cuda, no_tf32):
    # jamba's smoke config (d_state 8, f32) with remat trained two steps on
    # the card: 21 forward launches and 7 backward launches a step, no plain
    # call, the losses within 1e-4 of the CPU's
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b", smoke=True), remat=True)
    from repro_torch.optim import adamw
    from repro_torch.training.train_loop import TrainCfg, make_train_step

    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(2))
    losses = {}
    for dev in ("cpu", cuda):
        model = T.init_model(cfg, seed=0, device="cpu").to(dev)
        acfg = adamw.AdamWConfig(warmup_steps=1, total_steps=2)
        state = adamw.init(acfg, dict(model.named_parameters()))
        run = T.RunCfg()
        step = make_train_step(cfg, run, TrainCfg(adamw=acfg))
        counts = (SS.launches, SS.bwd_launches, SS.plain_calls, SS.plain_bwd_calls)
        losses[str(dev)] = [float(step(model, state, {"tokens": tokens.to(dev)})[0])
                            for _ in range(2)]
        if dev != "cpu":
            n = 2 * T.scan_forwards(cfg, run)
            assert n == 2 * 21
            assert (SS.launches, SS.bwd_launches, SS.plain_calls, SS.plain_bwd_calls) \
                == (counts[0] + n, counts[1] + 2 * 7, counts[2], counts[3])
    assert losses["cpu"] == pytest.approx(losses["cuda"], abs=1e-4)


def test_jamba_model_on_card_launches_the_scan_once_a_mamba_layer(cuda, no_tf32):
    # jamba's smoke config (d_state 8) in f32 on the card: a prefill and a
    # decode step launch the kernel once a Mamba layer; the logits and the
    # states within 1e-4 of the plain scan's run
    cfg = get_config("jamba-1.5-large-398b", smoke=True)
    model = T.init_model(cfg, seed=0, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(2))
    run, plain_run = T.RunCfg(), T.RunCfg(plain_scan=True)
    launches, plain = SS.launches, SS.plain_calls
    lk, ck = T.prefill(cfg, run, model, {"tokens": tokens.to(cuda)}, t_max=41)
    lk2, ck = T.decode_step(cfg, run, model, ck, lk[:, -1].argmax(-1)[:, None])
    assert (SS.launches, SS.plain_calls) == (launches + 2 * (cfg.n_layers - 1), plain)
    lp, cp = T.prefill(cfg, plain_run, model, {"tokens": tokens.to(cuda)}, t_max=41)
    lp2, cp = T.decode_step(cfg, plain_run, model, cp, lk[:, -1].argmax(-1)[:, None])
    for a, b in ((lk, lp), (lk2, lp2), (ck["ssm"], cp["ssm"]), (ck["conv"], cp["conv"])):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
