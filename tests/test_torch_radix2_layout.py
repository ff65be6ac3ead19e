"""The facts the radix-2 row engine (``src/repro_torch/csrc/radix2_stages.cuh``,
used by ``fft_radix2.cu`` and ``ring_rdma.cu``'s payload) rests on, checked
on the CPU.  The kernel itself runs only on the card
(``tests/test_torch_gpu.py``).

* The twiddle ROM's row s is row 0 at stride 2^s, bit for bit: the kernel
  stages row 0 alone and reads stage s's entry j at row 0's ``j << s``.
* The XOR swizzle (the header's ``kSwizzleF64``/``kSwizzleF32``) maps the
  lowest lane bits of every shared-memory access one-to-one onto the banks,
  for every log2 N the kernel instantiates: no bank conflicts.
* The pass schedule (three stages a pass on the elements ``i0 + (e << q)``,
  in place, the forward output read at bit-reversed slots, the roundtrip's
  inverse on the bit-reversed layout), written out here in numpy with the
  header's constants, gives the plain versions' results.
"""

import re
from pathlib import Path

import numpy as np
import pytest

# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.kernels.ref import twiddle_table_np as jax_rom
from repro_torch.kernels import fft_radix2, ref, ring_rdma

HEADER = (Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
          / "radix2_stages.cuh").read_text()
#: largest log2 N a row takes (the wrappers' shared-memory limit)
MAX_LOG2N = {d: fft_radix2.max_n(getattr(torch, d)).bit_length() - 1
             for d in ("float64", "float32")}
BANK_BITS = {"float64": 4, "float32": 5}  # 16 banks of 8 bytes a half-warp; 32 of 4


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER).group(1))


def _columns(dtype: str) -> list[int]:
    name = {"float64": "kSwizzleF64", "float32": "kSwizzleF32"}[dtype]
    body = re.search(rf"{name}\[kSwizzleCols\] = \{{([^}}]*)\}}", HEADER).group(1)
    return [int(c) for c in body.split(",")]


def shape(log2n: int) -> dict:
    """The header's ``Shape<L>``."""
    n = 1 << log2n
    eb = min(log2n, 3)
    ng = n >> eb
    trow = min(ng, _constant("kRowThreads"))
    sets = _constant("kSetThreads")
    return {"N": n, "EB": eb, "E": 1 << eb, "NG": ng, "NP": (log2n + 2) // 3,
            "TROW": trow, "G": ng // trow, "R": 1 if trow >= sets else sets // trow}


def q_of(log2n: int, p: int) -> int:
    return max(log2n - 3 - 3 * p, 0)


def swizzle(x, dtype: str):
    """The header's ``swizzle<T>`` on an integer array of block indices."""
    bb = BANK_BITS[dtype]
    f = np.zeros_like(x)
    for k, col in enumerate(_columns(dtype)):
        f ^= ((x >> (bb + k)) & 1) * col
    return x ^ f


def bitrev(x, log2n: int):
    y = np.zeros_like(x)
    for b in range(log2n):
        y |= ((x >> b) & 1) << (log2n - 1 - b)
    return y


def first_index(v, log2n: int, p: int):
    q, eb = q_of(log2n, p), shape(log2n)["EB"]
    return ((v >> q) << (q + eb)) | (v & ((1 << q) - 1))


@pytest.mark.parametrize("n", [2, 4, 16, 512, 8192, 16384])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_twiddle_rows_are_row_zero_at_stride(n, dtype):
    tr, ti = ref.twiddle_table_np(n, dtype)
    jr, ji = jax_rom(n, dtype)
    assert tr.tobytes() == np.asarray(jr).tobytes()
    assert ti.tobytes() == np.asarray(ji).tobytes()
    b = np.arange(n // 2)
    for s in range(tr.shape[0]):
        half = n >> (s + 1)
        at = (b & (half - 1)) << s  # row s, butterfly b: row 0 at j << s
        assert tr[s].tobytes() == tr[0][at].tobytes()
        assert ti[s].tobytes() == ti[0][at].tobytes()


def _lane_bit_positions(log2n: int):
    """For each shared-memory access of the engine, where in a block index
    (row << L | i) the lowest lane bits of a warp land: each pass's
    elements (forward layout, and bit-reversed for the roundtrip's
    inverse), and the natural reads of both layouts."""
    sh = shape(log2n)
    tbits = sh["TROW"].bit_length() - 1
    pats = []
    for p in range(sh["NP"]):
        q = q_of(log2n, p)
        pats.append(lambda lb, q=q: lb if lb < q else lb + sh["EB"])
    pats += [lambda lb, f=f: log2n - 1 - f(lb) for f in list(pats)]
    pats += [lambda lb: lb, lambda lb: log2n - 1 - lb]

    def positions(pat, bank_bits):
        return [pat(lb) if lb < tbits else log2n + lb - tbits for lb in range(bank_bits)]
    return pats, positions


@pytest.mark.parametrize("dtype,log2n", [(d, l) for d in ("float64", "float32")
                                         for l in range(1, MAX_LOG2N[d] + 1)])
def test_swizzle_keeps_every_access_conflict_free(dtype, log2n):
    bb = BANK_BITS[dtype]
    pats, positions = _lane_bit_positions(log2n)
    for pat in pats:
        # lanes 0 .. 2^bb - 1 vary these index bits; their banks must differ
        pos = positions(pat, bb)
        lanes = np.arange(1 << bb)
        x = np.zeros_like(lanes)
        for lb, at in enumerate(pos):
            x |= ((lanes >> lb) & 1) << at
        banks = swizzle(x, dtype) & ((1 << bb) - 1)
        assert len(set(banks.tolist())) == 1 << bb, (pos, banks)


def _engine(x, d, log2n, mode, dtype):
    """The header's rows() on one block of rows, in numpy: x, d complex
    (R, N); mode forward / inverse / roundtrip."""
    sh = shape(log2n)
    n, r_, e_ = sh["N"], sh["R"], sh["E"]
    tw0 = (lambda a: a[0][0] + 1j * a[1][0])(ref.twiddle_table_np(n, dtype))
    buf = np.zeros(r_ * n, complex)
    rows = np.arange(r_)[:, None]
    v = np.arange(sh["NG"])[None, :]

    def slot(i, rev):
        return swizzle((rows << log2n) | (bitrev(i, log2n) if rev else i), dtype)

    def passes(first, rev):
        for p in range(sh["NP"]):
            q = q_of(log2n, p)
            idx = [first_index(v, log2n, p) | (e << q) for e in range(e_)]
            vals = first(idx) if p == 0 else [buf[slot(i, rev)] for i in idx]
            for s in range(3 * p, min(3 * p + 3, log2n)):
                m = (log2n - 1 - s) - q
                for e in range(e_):
                    if e >> m & 1:
                        continue
                    j = (v & ((1 << q) - 1)) | ((e & ((1 << m) - 1)) << q)
                    w = tw0[j << s]
                    a, b = vals[e], vals[e | 1 << m]
                    vals[e], vals[e | 1 << m] = a + b, (a - b) * w
            for i, val in zip(idx, vals):
                buf[slot(i, rev)] = val

    passes(lambda idx: [np.conj(x[rows, i]) if mode == "inverse" else x[rows, i]
                        for i in idx], False)
    if mode == "roundtrip":
        passes(lambda idx: [np.conj(buf[slot(i, True)] * d[rows, i]) for i in idx], True)
    out = buf[slot(np.arange(n)[None, :], mode != "roundtrip")]
    return out if mode == "forward" else np.conj(out) / n


@pytest.mark.parametrize("mode", ["forward", "inverse", "roundtrip"])
@pytest.mark.parametrize("log2n", range(1, 15))
def test_pass_schedule_matches_plain_version(log2n, mode):
    sh = shape(log2n)
    rng = np.random.default_rng(log2n)
    x, d = (rng.standard_normal((sh["R"], sh["N"]))
            + 1j * rng.standard_normal((sh["R"], sh["N"])) for _ in range(2))
    got = _engine(x, d, log2n, mode, "float64")
    twr, twi = (torch.as_tensor(a) for a in ref.twiddle_table_np(sh["N"], "float64"))
    diag = (torch.as_tensor(d.real), torch.as_tensor(d.imag)) if mode == "roundtrip" else None
    wr, wi = ring_rdma.payload_plain(torch.as_tensor(x.real), torch.as_tensor(x.imag),
                                     twr, twi, diag, mode == "inverse")
    want = wr.numpy() + 1j * wi.numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
