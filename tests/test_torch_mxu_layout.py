"""The facts the four-step tensor-core kernel (``fft_mxu_tc_kernel`` in
``src/repro_torch/csrc/fft_mxu.cu``) rests on, checked on the CPU.  The
kernel itself runs only on the card (``tests/test_torch_gpu.py``).

* Its shape at every log2 N of the tensor-core path (6..13), from the
  source's constants: the tables in shared memory where they fit beside two
  stages (the main path's N = 256 and 512 among them), at least two stages
  below N = 8192, one block within the card's shared memory.
* The persistent schedule (sets of super-rows over the grid's blocks, the
  units of a set rotating over the compute warps) writes every element of
  every row exactly once, for ragged row counts.
* The fragment maps of ``mma.sync`` m16n8k16 (f64) and the two k
  permutations, written out here in numpy -- stage layout, fragment-ordered
  tables, each product as the hardware forms it from the lanes' fragments
  -- give ``four_step_planar``'s result.
* The stage's pad puts every fragment load of a half-warp on distinct
  banks; the fragment-ordered tables are read as contiguous 16-byte pairs;
  the direct stores of step 4 write whole 32-byte sectors.
"""

import re
from pathlib import Path

import numpy as np
import pytest

# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch.kernels import fft_mxu

SOURCE = (Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
          / "fft_mxu.cu").read_text()
TC_LOG2N = range(6, 14)
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


WARPS = _constant("kComputeWarps")
GROUP_ROWS = _constant("kGroupRows")
PAD = _constant("kPad")
MAX_G = _constant("kMaxG")
MAX_STAGES = _constant("kMaxStages")
MAX_SMEM = _constant("kMaxSmemBytes")


def shape(log2n: int) -> dict:
    """The source's ``Tc<L>``."""
    n1, n2 = 1 << (log2n // 2), 1 << (log2n - log2n // 2)
    s1 = 16 // n1 if n1 < 16 else 1
    n1p = n1 * s1
    mt = kc1 = n1p // 16
    nt2, kc3 = n2 // 8, (n2 + 15) // 16
    g = min(nt2, MAX_G)
    kg = nt2 // g
    u = mt * kg
    gstride = GROUP_ROWS * n2 + PAD
    plane = n1p // GROUP_ROWS * gstride
    d1f, twf, d2f = mt * kc1 * 512, mt * nt2 * 256, kc3 * nt2 * 256
    tables = d1f + twf + d2f
    r0 = 1 if u >= WARPS else WARPS // u

    def avail(t):
        return MAX_SMEM - t * 8 - 2 * MAX_STAGES * 8
    smem_tables = avail(tables) >= 2 * plane * 8
    r = 1 if smem_tables and avail(tables) < 2 * (r0 * 2 * plane * 8) else r0
    stage = r * 2 * plane
    smem_tab = tables if smem_tables else d1f
    stages = min(MAX_STAGES, avail(smem_tab) // (stage * 8))
    smem = (smem_tab + stages * stage) * 8 + 2 * stages * 8
    return dict(N=1 << log2n, N1=n1, N2=n2, S1=s1, N1P=n1p, MT=mt, KC1=kc1, NT2=nt2,
                KC3=kc3, G=g, KG=kg, U=u, GSTRIDE=gstride, PLANE=plane, D1F=d1f,
                TWF=twf, D2F=d2f, TABLES=tables, SMEM_TABLES=smem_tables,
                SMEM_TAB=smem_tab, R=r,
                STAGE=stage, STAGES=stages, SMEM=smem)


# ---- the fragment maps (the source's a_row .. perm3) --------------------------

def a_row(g, i):
    return g + 8 * (i & 1)


def a_col(t, i):
    return t + 4 * (i >> 1)


def b_row(t, i):
    return t + 4 * i


def c_row(g, i):
    return g + 8 * (i >> 1)


def c_col(t, i):
    return 2 * t + (i & 1)


def perm1(k):
    return 4 * (k & 3) + (k >> 2)


def perm3(k):
    return 8 * (k >> 3) + 2 * (k & 3) + ((k >> 2) & 1)


def test_fragment_maps_are_the_sources():
    # the maps mirrored above, as the source writes them
    for fn in ("a_row(int g, int i) { return g + 8 * (i & 1); }",
               "a_col(int t, int i) { return t + 4 * (i >> 1); }",
               "b_row(int t, int i) { return t + 4 * i; }",
               "c_row(int g, int i) { return g + 8 * (i >> 1); }",
               "c_col(int t, int i) { return 2 * t + (i & 1); }",
               "perm1(int k) { return 4 * (k & 3) + (k >> 2); }",
               "return 8 * (k >> 3) + 2 * (k & 3) + ((k >> 2) & 1);",
               "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64"):
        assert fn in SOURCE, fn
    # each map covers its tile once; the permutations are permutations
    for rows, cols, nvals, rmap, cmap in (
            (16, 16, 8, lambda i: a_row(G, i), lambda i: a_col(T, i)),
            (16, 8, 4, lambda i: b_row(T, i), lambda i: G),
            (16, 8, 4, lambda i: c_row(G, i), lambda i: c_col(T, i))):
        seen = np.zeros((rows, cols), int)
        for i in range(nvals):
            np.add.at(seen, (rmap(i), np.broadcast_to(cmap(i), (32,))), 1)
        assert (seen == 1).all()
    k = np.arange(16)
    assert sorted(perm1(k)) == list(k) and sorted(perm3(k)) == list(k)


def mma(a, b, c):
    """``mma.sync.m16n8k16`` on per-lane fragments a (32, 8), b (32, 4) and
    the accumulator c (32, 4), as the hardware assembles the tiles."""
    am = np.zeros((16, 16))
    bm = np.zeros((16, 8))
    for i in range(8):
        am[a_row(G, i), a_col(T, i)] = a[:, i]
    for i in range(4):
        bm[b_row(T, i), G] = b[:, i]
    d = am @ bm
    out = c.copy()
    for i in range(4):
        out[:, i] += d[c_row(G, i), c_col(T, i)]
    return out


# ---- the tables: values and fragment order -------------------------------------

def d1_value(sh, d1, mt, c, i):
    k1 = 16 * mt + a_row(G, i)
    j1 = 16 * c + perm1(a_col(T, i))
    v = d1[k1 % sh["N1"], j1 % sh["N1"]]
    return np.where(k1 // sh["N1"] == j1 // sh["N1"], v, 0.0) if sh["S1"] > 1 else v


def tw_value(sh, tw, mt, nt, i):
    return tw[(16 * mt + c_row(G, i)) % sh["N1"], 8 * nt + c_col(T, i)]


def d2_value(sh, d2, c3, nt2, i):
    j2 = 16 * c3 + perm3(b_row(T, i))
    return np.where(j2 < sh["N2"], d2[np.minimum(j2, sh["N2"] - 1), 8 * nt2 + G], 0.0)


def fragment_tables(sh, plan):
    """The fragment-ordered tables as the compute warps stage them:
    [fragment][plane][pair v][lane][2] for d1 (MT x KC1), tw (MT x NT2),
    d2 (KC3 x NT2)."""
    out = []
    for fn, nvals, frags, pair in ((d1_value, 8, [(mt, c) for mt in range(sh["MT"])
                                                  for c in range(sh["KC1"])], plan.d1),
                                   (tw_value, 4, [(mt, nt) for mt in range(sh["MT"])
                                                  for nt in range(sh["NT2"])], plan.tw),
                                   (d2_value, 4, [(c3, nt2) for c3 in range(sh["KC3"])
                                                  for nt2 in range(sh["NT2"])], plan.d2)):
        for f in frags:
            for table in pair:
                vals = np.stack([fn(sh, table, *f, i) for i in range(nvals)], 1)
                out.append(vals.reshape(32, nvals // 2, 2).transpose(1, 0, 2).ravel())
    tab = np.concatenate(out)
    assert tab.size == sh["TABLES"]
    return tab


def pairs(tab, base, nvals):
    """``Plan::pairs``: a lane's values of one fragment, re and im."""
    idx = base + (np.arange(nvals // 2)[:, None] * 32 + LANE) * 2
    get = lambda off: np.stack([tab[idx + off], tab[idx + off + 1]], 2) \
        .transpose(1, 0, 2).reshape(32, nvals)
    return get(0), get(nvals * 32)


# ---- the kernel in numpy --------------------------------------------------------

def stage_superrow(sh, xr, xi, srow, rows):
    """The producer's bulk copies of one super-row into its two planes."""
    planes = np.full((2, sh["PLANE"]), np.nan)
    for plane, x in enumerate((xr, xi)):
        for grp in range(sh["N1P"] // GROUP_ROWS):
            row = min(srow * sh["S1"] + grp * GROUP_ROWS // sh["N1"], rows - 1)
            j0 = (grp * GROUP_ROWS) % sh["N1"]
            seg = x[row, j0 * sh["N2"]:(j0 + GROUP_ROWS) * sh["N2"]]
            planes[plane, grp * sh["GSTRIDE"]:grp * sh["GSTRIDE"] + seg.size] = seg
    return planes


def unit(sh, planes, tab, mt, kg, inverse):
    """``unit<L>``: (row offset in the super-row, k1, k2, re, im) of the
    values a warp stores."""
    sr, si = planes
    dr = np.zeros((sh["G"], 32, 4))
    di = np.zeros((sh["G"], 32, 4))
    for c3 in range(sh["KC3"]):
        cr = np.zeros((2, 32, 4))
        ci = np.zeros((2, 32, 4))
        for c in range(sh["KC1"]):
            ar, ai = pairs(tab, (mt * sh["KC1"] + c) * 512, 8)
            for h in range(2):
                nt = 2 * c3 + h
                if nt >= sh["NT2"]:
                    continue
                at = (4 * c + T) * sh["GSTRIDE"] + 8 * nt + G
                br = np.stack([sr[at + i * sh["N2"]] for i in range(4)], 1)
                bi = np.stack([si[at + i * sh["N2"]] for i in range(4)], 1)
                bi = -bi if inverse else bi
                cr[h] = mma(ai, -bi, mma(ar, br, cr[h]))
                ci[h] = mma(ai, br, mma(ar, bi, ci[h]))
        for h in range(2):
            nt = 2 * c3 + h
            if nt < sh["NT2"]:
                wr, wi = pairs(tab, sh["D1F"] + (mt * sh["NT2"] + nt) * 256, 4)
                cr[h], ci[h] = cr[h] * wr - ci[h] * wi, cr[h] * wi + ci[h] * wr
        ar = np.zeros((32, 8))
        ai = np.zeros((32, 8))
        for i in range(8):
            q = i >> 1
            h, e = q >> 1, q & 1
            if 2 * c3 + h < sh["NT2"]:
                ar[:, i] = cr[h][:, 2 * (i & 1) + e]
                ai[:, i] = ci[h][:, 2 * (i & 1) + e]
        for n in range(sh["G"]):
            br, bi = pairs(tab, sh["D1F"] + sh["TWF"]
                           + (c3 * sh["NT2"] + kg * sh["G"] + n) * 256, 4)
            dr[n] = mma(-ai, bi, mma(ar, br, dr[n]))
            di[n] = mma(ai, br, mma(ar, bi, di[n]))
    for n in range(sh["G"]):
        for i in range(4):
            k1p = 16 * mt + c_row(G, i)
            k2 = 8 * (kg * sh["G"] + n) + c_col(T, i)
            yield k1p // sh["N1"], k1p % sh["N1"], k2, dr[n][:, i], di[n][:, i]


def kernel(xr, xi, inverse=False):
    """The tensor-core kernel on (rows, N) f64 arrays, one super-row at a
    time; every output element written exactly once."""
    rows, n = xr.shape
    sh = shape(n.bit_length() - 1)
    tab = fragment_tables(sh, fft_mxu.plan_np(n, "float64"))
    yr = np.full((rows, n), np.nan)
    yi = np.full((rows, n), np.nan)
    writes = np.zeros((rows, n), int)
    for srow in range(-(-rows // sh["S1"])):
        planes = stage_superrow(sh, xr, xi, srow, rows)
        for mt in range(sh["MT"]):
            for kg in range(sh["KG"]):
                for r, k1, k2, vr, vi in unit(sh, planes, tab, mt, kg, inverse):
                    row = srow * sh["S1"] + r
                    keep = row < rows
                    at = (row[keep], (k1 + sh["N1"] * k2)[keep])
                    if inverse:
                        vr, vi = vr / n, -(vi / n)
                    yr[at], yi[at] = vr[keep], vi[keep]
                    np.add.at(writes, at, 1)
    assert (writes == 1).all()
    return yr, yi


@pytest.mark.parametrize("log2n", TC_LOG2N)
def test_shape_fits_and_keeps_the_plan_out_of_the_row_path(log2n):
    sh = shape(log2n)
    assert sh["SMEM"] <= MAX_SMEM
    assert sh["N1"] * sh["N2"] == sh["N"] and sh["N1P"] % 16 == 0
    # the plan is in shared memory wherever it fits beside two stages: at
    # the main path's N (256, 512) and up to 2048; at N = 4096 and 8192
    # (192 KB and 448 KB of tables) d1 alone is, tw and d2 are read through
    # the read-only path
    assert sh["SMEM_TABLES"] == (log2n <= 11)
    assert sh["SMEM_TAB"] == (sh["TABLES"] if log2n <= 11 else sh["D1F"])
    assert sh["STAGES"] >= (2 if log2n <= 12 else 1)
    if log2n <= 10:  # a unit for every compute warp in each set
        assert sh["R"] * sh["U"] == WARPS


@pytest.mark.parametrize("log2n", [8, 9])
def test_main_path_shapes(log2n):
    # N = 256 and 512: one unit a row (a whole m-tile, step 1 once), 8 rows
    # a set, 4 and 3 stages of 8 rows in flight, the tables 12 and 28 KB
    sh = shape(log2n)
    assert (sh["U"], sh["R"], sh["S1"], sh["KG"]) == (1, 8, 1, 1)
    assert (sh["STAGES"], sh["TABLES"] * 8) == {8: (4, 12288), 9: (3, 28672)}[log2n]


def schedule(rows: int, log2n: int, grid: int):
    """The kernel's work, as (block, set j, warp, super-row, mt, kg): the
    producer's sets and the compute warps' rotating units."""
    sh = shape(log2n)
    srows = -(-rows // sh["S1"])
    sets = -(-srows // sh["R"])
    units = sh["R"] * sh["U"]
    blocks = min(sets, grid)
    for b in range(blocks):
        for j, s in enumerate(range(b, sets, blocks)):
            for w in range(WARPS):
                first = (w - (j * units) % WARPS + WARPS) % WARPS
                for u in range(first, units, WARPS):
                    r, rest = divmod(u, sh["U"])
                    srow = s * sh["R"] + r
                    if srow < srows:
                        yield b, j, w, srow, rest // sh["KG"], rest % sh["KG"]


@pytest.mark.parametrize("log2n", TC_LOG2N)
@pytest.mark.parametrize("rows", [1, 5, 37, 200])
def test_schedule_covers_every_row_once(rows, log2n):
    # 200 rows at a grid of 132 blocks; 1, 5, 37 below it
    sh = shape(log2n)
    count = np.zeros((rows, sh["N1"], sh["N2"] // 8), int)  # (row, k1, k2 n-tile)
    busy = {}
    for b, j, w, srow, mt, kg in schedule(rows, log2n, 132):
        busy.setdefault((b, j), set()).add(w)
        for k1p in range(16 * mt, 16 * mt + 16):
            row = srow * sh["S1"] + k1p // sh["N1"]
            if row < rows:
                count[row, k1p % sh["N1"], kg * sh["G"]:(kg + 1) * sh["G"]] += 1
    assert (count == 1).all()
    # a set's units spread over distinct warps where it has enough of them
    for (b, j), warps in busy.items():
        assert len(warps) <= WARPS


def test_schedule_covers_the_main_paths_row_count():
    # 257·512 rows at N = 512 (the Y and Z phases) over 132 blocks, in
    # closed form: each super-row once, sets spread evenly
    rows, log2n, grid = 257 * 512, 9, 132
    sh = shape(log2n)
    seen = np.zeros(rows, int)
    per_block = np.zeros(grid, int)
    for b, j, w, srow, mt, kg in schedule(rows, log2n, grid):
        seen[srow] += 1
        per_block[b] += 1
    assert (seen == sh["MT"] * sh["KG"]).all()
    assert per_block.max() - per_block.min() <= sh["R"]


def test_schedule_of_the_rows_of_a_tiny_grid():
    # fewer sets than blocks: one block a set, every row once
    rows, log2n = 5, 9
    work = list(schedule(rows, log2n, 132))
    assert sorted(s for *_, s, _, _ in work) == list(range(rows))
    assert len({b for b, *_ in work}) == 1


@pytest.mark.parametrize("log2n", TC_LOG2N)
@pytest.mark.parametrize("inverse", [False, True])
def test_fragment_maps_give_the_plain_version(log2n, inverse):
    n = 1 << log2n
    sh = shape(log2n)
    rows = 2 * sh["S1"] - 1 if sh["S1"] > 1 else 2  # a ragged super-row at N = 64, 128
    rng = np.random.default_rng(log2n + 10 * inverse)
    xr, xi = rng.standard_normal((2, rows, n))
    got = kernel(xr, xi, inverse)
    want = fft_mxu.four_step_planar(torch.from_numpy(xr), torch.from_numpy(xi),
                                    inverse=inverse)
    scale = max(np.abs(w.numpy()).max() for w in want)
    for g_, w in zip(got, want):
        assert np.abs(g_ - w.numpy()).max() <= 1e-12 * scale
    z = (np.fft.ifft if inverse else np.fft.fft)(xr + 1j * xi)
    assert np.abs(got[0] + 1j * got[1] - z).max() <= 1e-12 * np.abs(z).max()


@pytest.mark.parametrize("log2n", TC_LOG2N)
def test_stage_pad_keeps_fragment_loads_conflict_free(log2n):
    # step 1's B fragments: 8-byte loads, a half-warp (16 lanes) a
    # wavefront over 16 banks of 8 bytes; every (c, n-tile, i)
    sh = shape(log2n)
    for c in range(sh["KC1"]):
        for nt in range(sh["NT2"]):
            for i in range(4):
                at = (4 * c + T) * sh["GSTRIDE"] + 8 * nt + G + i * sh["N2"]
                for half in (slice(0, 16), slice(16, 32)):
                    banks = at[half] % 16
                    assert len(set(banks.tolist())) == 16, (c, nt, i, banks)
    # the stage's groups and planes start on 16-byte boundaries (bulk copy)
    assert sh["GSTRIDE"] % 2 == 0 and sh["PLANE"] % 2 == 0
    assert (GROUP_ROWS * sh["N2"] * 8) % 16 == 0


def test_fragment_ordered_tables_are_read_as_contiguous_pairs():
    # Plan::pairs: lane l's pair v at (v·32 + l)·2 -- a quarter-warp's 8
    # lanes read 128 contiguous bytes: one wavefront, no conflict
    for nvals in (4, 8):
        for v in range(nvals // 2):
            off = (v * 32 + LANE) * 2 * 8
            for q in range(4):
                lanes = off[8 * q:8 * q + 8]
                assert (np.diff(lanes) == 16).all() and lanes[0] % 128 == 0


@pytest.mark.parametrize("log2n", TC_LOG2N)
def test_direct_stores_write_whole_sectors(log2n):
    # step 4: each store instruction (n-tile, value i) of a warp covers whole
    # 32-byte sectors of the output row (8 lanes on 8 consecutive k1)
    sh = shape(log2n)
    for mt in range(sh["MT"]):
        for nt2 in range(sh["NT2"]):
            for i in range(4):
                k1p = 16 * mt + c_row(G, i)
                k2 = 8 * nt2 + c_col(T, i)
                byte = ((k1p // sh["N1"]) * sh["N"] + k1p % sh["N1"]
                        + sh["N1"] * k2) * 8
                sectors, counts = np.unique(byte // 32, return_counts=True)
                assert (counts == 4).all(), (mt, nt2, i)
