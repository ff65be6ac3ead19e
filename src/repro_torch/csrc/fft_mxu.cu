// Batched four-step (Bailey) 1D FFT for Hopper (sm_90a), f64 products on
// the FP64 tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fft_mxu.py:80
// (fft1d_mxu, body _kernel, tables _plan), which ran the FFT as dense
// complex matrix products on the TPU's matrix unit.
//
// What it computes, per row of length N = n1*n2 (a power of two >= 2,
// n1 = 2^floor(log2(N)/2), planar re/im), with the row viewed as
// A[j1][j2] (n = j1*n2 + j2):
//   step 1  B = d1 @ A          length-n1 DFTs over j1   (d1: n1 x n1)
//   step 2  C = B o tw          twiddles W_N^(k1*j2)     (tw: n1 x n2)
//   step 3  D = C @ d2          length-n2 DFTs over j2   (d2: n2 x n2)
//   step 4  X[k1 + n1*k2] = D[k1][k2]
// Each complex product is four real products (re*re - im*im, re*im + im*re),
// as in the reference.  With `inverse` set, the imaginary part is negated on
// load, and on store the result is scaled by 1/N and its imaginary part
// negated again: ifft(x) = conj(fft(conj(x))) / N.
//
// Bound.  One call reads re/im once and writes re/im once (4*B*N*8 bytes in
// f64) for 8*N*(n1+n2) flops a row: 12 flop/byte at N=512, against the
// H100's 20 flop/byte of FP64 tensor-core peak (67 TFLOP/s) over HBM
// (3.35 TB/s).  Bytes bound it, and only if the tensor cores run near their
// peak beside the copies: at N=512 the products need 60 % of the byte
// time.  On the card, mma.sync m8n8k4 (f64) reaches 32.7 TFLOP/s and
// m16n8k16 66.4 (the probe below, fft_mxu_mma_rate), so the products run
// as m16n8k16 -- at m8n8k4's rate they alone would take longer than the
// bytes.
//
// Tensor-core path (f64, N >= 64), the design:
//  * A persistent grid of one block an SM, 8 warps.  Sets of R rows arrive
//    in a ring of shared-memory stages by bulk asynchronous copies
//    (cp.async.bulk, 1-D TMA) under mbarriers (the copies' bytes), so the
//    next sets are in flight while the warps multiply a set.  The last
//    warp to be done with a stage (a counter in shared memory) refills it:
//    no warp waits for another, and with no producer warp each of the 8
//    takes 255 registers (9 warps would leave 168: 3 on one sub-partition).
//  * A warp computes a unit -- one 16-row m-tile of k1 and a group of up to
//    four 8-column n-tiles of k2 -- entirely in registers, streaming over
//    j2 in chunks of 16: step 1 for two n-tiles of j2, their twiddles, and
//    at once their contribution to step 3.  The accumulator of step 1 is
//    the A operand of step 3 as it lies in the registers (its columns are
//    step 3's k, in a permuted order that d2's fragments follow), so C never
//    goes through shared memory.  At N <= 1024 a unit is a whole m-tile and
//    step 1 runs once; above, the units of an m-tile repeat its step 1.
//  * Rows of n1 = 8 (N = 64, 128) pair up: two consecutive rows are one
//    16 x n2 matrix, d1 becomes diag(d1, d1), and one m-tile holds both.
//  * The plan out of the per-row path: each block stages the tables once
//    into shared memory in fragment order (each lane's 16-byte pairs side by
//    side: conflict-free vector loads) where they fit beside two stages --
//    28 KB at N=512, up to N=2048.  At N=4096 and 8192 (192 and 448 KB) d1
//    alone is staged and tw and d2 are read through the read-only path.
//  * A stage keeps the rows' j1 in groups of four (one bulk copy each) with
//    a pad of kPad doubles after each group; step 1's k order (j1 = 4t + i
//    within a chunk of 16, lane (g, t)) then puts the sixteen lanes of a
//    half-warp's fragment loads on sixteen distinct banks.
//  * Step 4 needs no staging: a lane's D values are stored straight to
//    device memory, 8 lanes on 8 consecutive k1 (64 bytes), so every store
//    instruction writes whole 32-byte sectors.
//  * __launch_bounds__ with a minimum of one block, so that ptxas takes the
//    registers the unit needs instead of spilling.
//
// CUDA-core path (f32 at every N, f64 below N = 64; N = 2 is n1 = 1,
// n2 = 2): a full-precision FMA loop, one output element a thread, with A
// and C in separate shared buffers.  f32 deliberately avoids TF32, which
// keeps ~3 digits.
//
// C interface (no PyTorch headers, bound with ctypes): each entry point
// launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tma.cuh"

namespace {

// ---- the tensor-core path's constants ---------------------------------------

constexpr int kComputeWarps = 8;  // two a sub-partition: 255 registers a thread
constexpr int kThreads = kComputeWarps * 32;
constexpr int kGroupRows = 4;  // j1 rows a bulk copy (a stage's row group)
constexpr int kPad = 4;        // doubles after each row group of a stage
constexpr int kMaxG = 4;       // k2 n-tiles a unit
constexpr int kMaxStages = 4;
constexpr int kMaxSmemBytes = 232448;  // dynamic shared memory of one block

// ---- mma.sync.aligned.m16n8k16.row.col.f64 ----------------------------------
// The fragment maps of the one shape the kernel runs, lane = 4g + t:
//   A (16 x 16): a[i], i < 8, at row g + 8*(i & 1), col t + 4*(i >> 1)
//   B (16 x 8):  b[i], i < 4, at row t + 4*i,        col g
//   C (16 x 8):  c[i], i < 4, at row g + 8*(i >> 1), col 2t + (i & 1)
// (PTX ISA; CUTLASS's SM90_16x8x16_F64F64F64F64_TN).  A product's k may be
// any permutation of the contracted index, the same for A and B:
//   step 1, chunk c of j1:  k -> j1 = 16c + 4*(k & 3) + (k >> 2)
//   step 3, chunk c of j2:  k -> j2 = 16c + 8*(k >> 3) + 2*(k & 3) + ((k >> 2) & 1)
// The first spreads a fragment's lanes over the stage's row groups; the
// second makes step 1's accumulator (col 2t + e of n-tile 2c + h) step 3's
// A fragment (k = t + 4*(2h + e)).
__device__ __forceinline__ int a_row(int g, int i) { return g + 8 * (i & 1); }
__device__ __forceinline__ int a_col(int t, int i) { return t + 4 * (i >> 1); }
__device__ __forceinline__ int b_row(int t, int i) { return t + 4 * i; }
__device__ __forceinline__ int c_row(int g, int i) { return g + 8 * (i >> 1); }
__device__ __forceinline__ int c_col(int t, int i) { return 2 * t + (i & 1); }
__device__ __forceinline__ int perm1(int k) { return 4 * (k & 3) + (k >> 2); }
__device__ __forceinline__ int perm3(int k) {
  return 8 * (k >> 3) + 2 * (k & 3) + ((k >> 2) & 1);
}

__device__ __forceinline__ void mma(double (&c)[4], const double (&a)[8],
                                    const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// The shape of the tensor-core path at N = 2^L.
template <int L>
struct Tc {
  static constexpr int N = 1 << L;
  static constexpr int N1 = 1 << (L / 2), N2 = 1 << (L - L / 2);
  static constexpr int S1 = N1 < 16 ? 16 / N1 : 1;  // rows a 16-row super-row
  static constexpr int N1P = N1 * S1;                // its k1 (and j1) extent
  static constexpr int MT = N1P / 16;                // m-tiles of k1
  static constexpr int KC1 = N1P / 16;               // step 1's k chunks
  static constexpr int NT2 = N2 / 8;                 // n-tiles of j2 and of k2
  static constexpr int KC3 = (N2 + 15) / 16;         // step 3's k chunks
  static constexpr int G = NT2 < kMaxG ? NT2 : kMaxG;  // k2 n-tiles a unit
  static constexpr int KG = NT2 / G;
  static constexpr int U = MT * KG;                  // units a super-row
  static constexpr int GSTRIDE = kGroupRows * N2 + kPad;
  static constexpr int PLANE = N1P / kGroupRows * GSTRIDE;  // doubles
  // the plan in fragment order: d1 (MT x KC1 A fragments), tw (MT x NT2
  // accumulator fragments), d2 (KC3 x NT2 B fragments); 2 planes, 32 lanes
  static constexpr int D1F = MT * KC1 * 2 * 8 * 32;
  static constexpr int TWF = MT * NT2 * 2 * 4 * 32;
  static constexpr int D2F = KC3 * NT2 * 2 * 4 * 32;
  static constexpr int TABLES = D1F + TWF + D2F;
  // super-rows a stage: a unit for each warp, or one super-row where the
  // tables and two such stages would not fit
  static constexpr int R0 = U >= kComputeWarps ? 1 : kComputeWarps / U;
  static constexpr int avail(int tables) {
    return kMaxSmemBytes - tables * 8 - 2 * kMaxStages * 8;
  }
  static constexpr bool kSmemTables = avail(TABLES) >= 2 * PLANE * 8;
  static constexpr int R =
      kSmemTables && avail(TABLES) < 2 * (R0 * 2 * PLANE * 8) ? 1 : R0;
  static constexpr int STAGE = R * 2 * PLANE;  // doubles
  // the tables in shared memory: all of them, or d1 alone (its fragments
  // are the ones the read-only path would scatter over most sectors)
  static constexpr int SMEM_TAB = kSmemTables ? TABLES : D1F;
  static constexpr int fit = avail(SMEM_TAB) / (STAGE * 8);
  static constexpr int STAGES = fit < kMaxStages ? fit : kMaxStages;
  static constexpr size_t SMEM =
      (static_cast<size_t>(SMEM_TAB) + static_cast<size_t>(STAGES) * STAGE) * 8 +
      2 * STAGES * 8;
  static_assert(STAGES >= 1, "a stage must fit");
};

// The value of each fragment slot, from the natural tables (row-major d1,
// tw, d2 as plan_np makes them): d1 block-diagonal over a super-row's rows,
// d2's rows past n2 zero (N = 64, where a 16-wide k chunk covers 8 j2).
template <int L>
__device__ __forceinline__ double d1_value(const double* __restrict__ d1,
                                           int mt, int c, int lane, int i) {
  using T = Tc<L>;
  const int k1 = 16 * mt + a_row(lane >> 2, i);
  const int j1 = 16 * c + perm1(a_col(lane & 3, i));
  if (T::S1 > 1 && k1 / T::N1 != j1 / T::N1) return 0.0;
  return __ldg(d1 + (k1 % T::N1) * T::N1 + j1 % T::N1);
}

template <int L>
__device__ __forceinline__ double tw_value(const double* __restrict__ tw,
                                           int mt, int nt, int lane, int i) {
  using T = Tc<L>;
  const int k1 = 16 * mt + c_row(lane >> 2, i);
  const int j2 = 8 * nt + c_col(lane & 3, i);
  return __ldg(tw + (k1 % T::N1) * T::N2 + j2);
}

template <int L>
__device__ __forceinline__ double d2_value(const double* __restrict__ d2,
                                           int c3, int nt2, int lane, int i) {
  using T = Tc<L>;
  const int j2 = 16 * c3 + perm3(b_row(lane & 3, i));
  const int k2 = 8 * nt2 + (lane >> 2);
  return j2 < T::N2 ? __ldg(d2 + j2 * T::N2 + k2) : 0.0;
}

// The plan as the warps read it: fragment-ordered in shared memory -- all
// of it where it fits (kSmemTables), else d1 there and tw and d2 from the
// natural tables through the read-only path.
// Fragment order: [fragment][plane][pair v][lane][2], value index 2v + w.
template <int L>
struct Plan {
  using T = Tc<L>;
  const double* tab;
  const double *d1r, *d1i, *twr, *twi, *d2r, *d2i;

  template <int kVals>
  __device__ __forceinline__ static void pairs(const double* f, int lane,
                                               double (&re)[kVals],
                                               double (&im)[kVals]) {
#pragma unroll
    for (int v = 0; v < kVals / 2; ++v) {
      const double2 r = *reinterpret_cast<const double2*>(f + (v * 32 + lane) * 2);
      const double2 m = *reinterpret_cast<const double2*>(
          f + kVals * 32 + (v * 32 + lane) * 2);
      re[2 * v] = r.x;
      re[2 * v + 1] = r.y;
      im[2 * v] = m.x;
      im[2 * v + 1] = m.y;
    }
  }
  __device__ __forceinline__ void d1(int mt, int c, int lane, double (&re)[8],
                                     double (&im)[8]) const {
    pairs<8>(tab + (mt * T::KC1 + c) * 2 * 8 * 32, lane, re, im);
  }
  __device__ __forceinline__ void tw(int mt, int nt, int lane, double (&re)[4],
                                     double (&im)[4]) const {
    if constexpr (T::kSmemTables) {
      pairs<4>(tab + T::D1F + (mt * T::NT2 + nt) * 2 * 4 * 32, lane, re, im);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        re[i] = tw_value<L>(twr, mt, nt, lane, i);
        im[i] = tw_value<L>(twi, mt, nt, lane, i);
      }
    }
  }
  __device__ __forceinline__ void d2(int c3, int nt2, int lane, double (&re)[4],
                                     double (&im)[4]) const {
    if constexpr (T::kSmemTables) {
      pairs<4>(tab + T::D1F + T::TWF + (c3 * T::NT2 + nt2) * 2 * 4 * 32, lane,
               re, im);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        re[i] = d2_value<L>(d2r, c3, nt2, lane, i);
        im[i] = d2_value<L>(d2i, c3, nt2, lane, i);
      }
    }
  }
  // Every thread writes its share of the fragment-ordered tables that live
  // in shared memory (once a block); the caller passes a barrier after.
  __device__ void stage(double* out, int tid) const {
    for (int e = tid; e < T::SMEM_TAB; e += kThreads) {
      int x = e;
      const int w = x & 1, lane = (x >> 1) & 31;
      double v;
      if (x < T::D1F) {
        const int pv = x >> 6, i = 2 * (pv & 3) + w, plane = (pv >> 2) & 1;
        const int f = pv >> 3;
        v = d1_value<L>(plane ? d1i : d1r, f / T::KC1, f % T::KC1, lane, i);
      } else if ((x -= T::D1F) < T::TWF) {
        const int pv = x >> 6, i = 2 * (pv & 1) + w, plane = (pv >> 1) & 1;
        const int f = pv >> 2;
        v = tw_value<L>(plane ? twi : twr, f / T::NT2, f % T::NT2, lane, i);
      } else {
        x -= T::TWF;
        const int pv = x >> 6, i = 2 * (pv & 1) + w, plane = (pv >> 1) & 1;
        const int f = pv >> 2;
        v = d2_value<L>(plane ? d2i : d2r, f / T::NT2, f % T::NT2, lane, i);
      }
      out[e] = v;
    }
  }
};

// One unit: m-tile mt and k2 n-tiles kg*G .. kg*G + G-1 of the super-row
// whose planes lie at (sr, si) in a stage; results straight to device
// memory.
template <int L>
__device__ __forceinline__ void unit(const double* __restrict__ sr,
                                     const double* __restrict__ si,
                                     const Plan<L>& plan, int mt, int kg,
                                     long long row0, long long rows,
                                     double* __restrict__ yr,
                                     double* __restrict__ yi, int lane,
                                     bool inverse, double scale) {
  using T = Tc<L>;
  const int g = lane >> 2, t = lane & 3;
  double dr[T::G][4], di[T::G][4];
#pragma unroll
  for (int n = 0; n < T::G; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dr[n][i] = di[n][i] = 0.0;

#pragma unroll 1
  for (int c3 = 0; c3 < T::KC3; ++c3) {
    // steps 1 and 2 for the n-tiles 2*c3 + h of j2 (h < 2, those < NT2)
    double cr[2][4], ci[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) cr[h][i] = ci[h][i] = 0.0;
#pragma unroll 1
    for (int c = 0; c < T::KC1; ++c) {
      double ar[8], ai[8];
      plan.d1(mt, c, lane, ar, ai);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nt = 2 * c3 + h;
        if (nt >= T::NT2) continue;
        // B: j1 = 16c + 4t + i (group 4c + t, row i), j2 = 8nt + g
        const int at = (4 * c + t) * T::GSTRIDE + 8 * nt + g;
        double br[4], bi[4], nbi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          br[i] = sr[at + i * T::N2];
          const double v = si[at + i * T::N2];
          bi[i] = inverse ? -v : v;
          nbi[i] = -bi[i];
        }
        mma(cr[h], ar, br);
        mma(cr[h], ai, nbi);
        mma(ci[h], ar, bi);
        mma(ci[h], ai, br);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nt = 2 * c3 + h;
      if (nt >= T::NT2) continue;
      double wr[4], wi[4];
      plan.tw(mt, nt, lane, wr, wi);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double br = cr[h][i], bi = ci[h][i];
        cr[h][i] = br * wr[i] - bi * wi[i];
        ci[h][i] = br * wi[i] + bi * wr[i];
      }
    }
    // step 3: the accumulators are the A fragment (k = t + 4q, q = 2h + e)
    double ar[8], ai[8], nai[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = i >> 1, h = q >> 1, e = q & 1;
      const bool real = 2 * c3 + h < T::NT2;
      ar[i] = real ? cr[h][2 * (i & 1) + e] : 0.0;
      ai[i] = real ? ci[h][2 * (i & 1) + e] : 0.0;
      nai[i] = -ai[i];
    }
#pragma unroll
    for (int n = 0; n < T::G; ++n) {
      double br[4], bi[4];
      plan.d2(c3, kg * T::G + n, lane, br, bi);
      mma(dr[n], ar, br);
      mma(dr[n], nai, bi);
      mma(di[n], ar, bi);
      mma(di[n], ai, br);
    }
  }

  // step 4: X[k1 + n1*k2] of row row0 + k1' / n1, straight from registers
#pragma unroll
  for (int n = 0; n < T::G; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k1p = 16 * mt + c_row(g, i);
      const int k2 = 8 * (kg * T::G + n) + c_col(t, i);
      const long long row = row0 + k1p / T::N1;
      if (row >= rows) continue;
      const size_t at = static_cast<size_t>(row) * T::N +
                        (k1p % T::N1) + static_cast<size_t>(T::N1) * k2;
      if (inverse) {
        yr[at] = dr[n][i] * scale;
        yi[at] = -(di[n][i] * scale);
      } else {
        yr[at] = dr[n][i];
        yi[at] = di[n][i];
      }
    }
}

// Set `set` of super-rows into the stage at `st`: its bytes announced on
// `full`, its bulk copies (one a row group and plane) spread over the
// calling warp's lanes.
template <int L>
__device__ __forceinline__ void load_set(double* st, uint64_t* full,
                                         const double* __restrict__ xr,
                                         const double* __restrict__ xi,
                                         long long set, long long srows,
                                         long long rows, int lane) {
  using T = Tc<L>;
  const long long sr0 = set * T::R;
  const int n = static_cast<int>(srows - sr0 < T::R ? srows - sr0 : T::R);
  constexpr int kCopies = 2 * (T::N1P / kGroupRows);  // a super-row's
  constexpr uint32_t kBytes = kGroupRows * T::N2 * 8;
  if (lane == 0) sm90::mbar_expect_tx(full, n * kCopies * kBytes);
  __syncwarp();
  for (int q = lane; q < n * kCopies; q += 32) {
    const int r = q / kCopies, plane = (q % kCopies) / (kCopies / 2);
    const int grp = q % (kCopies / 2);
    // a super-row's missing second row (odd row count) repeats its first:
    // finite values times the zero half of diag(d1, d1)
    long long row = (sr0 + r) * T::S1 + grp * kGroupRows / T::N1;
    if (row >= rows) row = rows - 1;
    const double* src = (plane ? xi : xr) + row * T::N +
                        (grp * kGroupRows % T::N1) * T::N2;
    sm90::bulk_load(st + (2 * r + plane) * T::PLANE + grp * T::GSTRIDE, src, kBytes,
                    full);
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads, 1) fft_mxu_tc_kernel(
    const double* __restrict__ xr, const double* __restrict__ xi,
    const double* __restrict__ d1r, const double* __restrict__ d1i,
    const double* __restrict__ twr, const double* __restrict__ twi,
    const double* __restrict__ d2r, const double* __restrict__ d2i,
    double* __restrict__ yr, double* __restrict__ yi, long long rows,
    int inverse, double scale) {
  using T = Tc<L>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* tab = reinterpret_cast<double*>(smem_raw);
  double* stages = tab + T::SMEM_TAB;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + T::STAGES * T::STAGE);
  unsigned* released = reinterpret_cast<unsigned*>(full + T::STAGES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long srows = (rows + T::S1 - 1) / T::S1;  // super-rows
  const long long sets = (srows + T::R - 1) / T::R;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      released[s] = 0;
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (warp == 0)  // this block's first sets, one a stage
    for (int s = 0; s < T::STAGES; ++s) {
      const long long set = blockIdx.x + static_cast<long long>(s) * gridDim.x;
      if (set >= sets) break;
      load_set<L>(stages + s * T::STAGE, &full[s], xr, xi, set, srows, rows, lane);
    }
  const Plan<L> plan{tab, d1r, d1i, twr, twi, d2r, d2i};
  plan.stage(tab, threadIdx.x);
  __syncthreads();

  constexpr int kUnits = T::R * T::U;  // a set's
  long long j = 0;
  for (long long set = blockIdx.x; set < sets; set += gridDim.x, ++j) {
    const int slot = static_cast<int>(j % T::STAGES);
    sm90::mbar_wait(&full[slot], static_cast<uint32_t>(j / T::STAGES) & 1);
    double* st = stages + static_cast<size_t>(slot) * T::STAGE;
    // units rotate over the warps from set to set (a set may hold fewer
    // units than there are warps)
    const int first = static_cast<int>(
        (warp - (j * kUnits) % kComputeWarps + kComputeWarps) % kComputeWarps);
    for (int u = first; u < kUnits; u += kComputeWarps) {
      const int r = u / T::U, mt = (u % T::U) / T::KG, kg = u % T::KG;
      const long long srow = set * T::R + r;
      if (srow >= srows) continue;
      unit<L>(st + 2 * r * T::PLANE, st + (2 * r + 1) * T::PLANE, plan, mt, kg,
              srow * T::S1, rows, yr, yi, lane, inverse != 0, scale);
    }
    // the last warp to be done with the stage refills it with the set
    // STAGES later (no warp waits for the others)
    __syncwarp();
    unsigned done = 0;
    if (lane == 0) {
      __threadfence_block();
      done = atomicAdd(&released[slot], 1u) + 1;
    }
    done = __shfl_sync(0xffffffffu, done, 0);
    const long long next = set + static_cast<long long>(T::STAGES) * gridDim.x;
    if (done % kComputeWarps == 0 && next < sets) {
      // the warps' reads of the stage come before the copies that overwrite it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load_set<L>(st, &full[slot], xr, xi, next, srows, rows, lane);
    }
  }
}

template <typename T>
__global__ void fft_mxu_fma_kernel(
    const T* __restrict__ xr, const T* __restrict__ xi,
    const T* __restrict__ d1r, const T* __restrict__ d1i,
    const T* __restrict__ twr, const T* __restrict__ twi,
    const T* __restrict__ d2r, const T* __restrict__ d2i,
    T* __restrict__ yr, T* __restrict__ yi, int log2n1, int log2n2,
    int inverse, T scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n1 = 1 << log2n1, n2 = 1 << log2n2, n = n1 * n2;
  T* ar = reinterpret_cast<T*>(smem_raw);
  T* ai = ar + n;
  T* cr = ai + n;
  T* ci = cr + n;
  const size_t base = static_cast<size_t>(blockIdx.x) * static_cast<size_t>(n);

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    ar[j] = xr[base + j];
    const T v = xi[base + j];
    ai[j] = inverse ? -v : v;
  }
  __syncthreads();

  // steps 1 and 2: C[k1][j2] = tw[k1][j2] * sum_j1 d1[k1][j1] A[j1][j2]
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int k1 = e >> log2n2, j2 = e & (n2 - 1);
    T br = 0, bi = 0;
    for (int j1 = 0; j1 < n1; ++j1) {
      const T wr = __ldg(d1r + k1 * n1 + j1), wi = __ldg(d1i + k1 * n1 + j1);
      const T vr = ar[j1 * n2 + j2], vi = ai[j1 * n2 + j2];
      br += wr * vr - wi * vi;
      bi += wr * vi + wi * vr;
    }
    const T tr = __ldg(twr + e), ti = __ldg(twi + e);
    cr[e] = br * tr - bi * ti;
    ci[e] = br * ti + bi * tr;
  }
  __syncthreads();

  // steps 3 and 4: X[k1 + n1*k2] = sum_j2 C[k1][j2] d2[j2][k2]
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int k1 = e >> log2n2, k2 = e & (n2 - 1);
    T dr = 0, di = 0;
    for (int j2 = 0; j2 < n2; ++j2) {
      const T ur = cr[k1 * n2 + j2], ui = ci[k1 * n2 + j2];
      const T wr = __ldg(d2r + j2 * n2 + k2), wi = __ldg(d2i + j2 * n2 + k2);
      dr += ur * wr - ui * wi;
      di += ur * wi + ui * wr;
    }
    ar[k1 + (k2 << log2n1)] = dr;
    ai[k1 + (k2 << log2n1)] = di;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    if (inverse) {
      yr[base + j] = ar[j] * scale;
      yi[base + j] = -ai[j] * scale;
    } else {
      yr[base + j] = ar[j];
      yi[base + j] = ai[j];
    }
  }
}

struct Args {
  const void *xr, *xi, *d1r, *d1i, *twr, *twi, *d2r, *d2i;
  void *yr, *yi;
  long long rows;
  int log2n1, log2n2, inverse;
  cudaStream_t stream;
};

template <typename T>
int launch_fma(const Args& a) {
  const int n = 1 << (a.log2n1 + a.log2n2);
  const size_t smem = 4u * static_cast<size_t>(n) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      fft_mxu_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = n < 256 ? n : 256;
  fft_mxu_fma_kernel<T><<<static_cast<unsigned>(a.rows), threads, smem,
                          a.stream>>>(
      static_cast<const T*>(a.xr), static_cast<const T*>(a.xi),
      static_cast<const T*>(a.d1r), static_cast<const T*>(a.d1i),
      static_cast<const T*>(a.twr), static_cast<const T*>(a.twi),
      static_cast<const T*>(a.d2r), static_cast<const T*>(a.d2i),
      static_cast<T*>(a.yr), static_cast<T*>(a.yi), a.log2n1, a.log2n2,
      a.inverse, static_cast<T>(1.0 / n));
  return static_cast<int>(cudaGetLastError());
}

// A persistent grid: at most as many blocks as fit on the card at once
// (one an SM), set up once a device.
template <int L>
int launch_tc(const Args& a) {
  using T = Tc<L>;
  static int cached_dev = -1;
  static long long resident = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != cached_dev) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(fft_mxu_tc_kernel<L>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(T::SMEM))) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fft_mxu_tc_kernel<L>, kThreads, T::SMEM)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident = static_cast<long long>(sms) * per_sm;
    cached_dev = dev;
  }
  const long long sets = ((a.rows + T::S1 - 1) / T::S1 + T::R - 1) / T::R;
  const long long blocks = sets < resident ? sets : resident;
  fft_mxu_tc_kernel<L><<<static_cast<unsigned>(blocks), kThreads, T::SMEM,
                         a.stream>>>(
      static_cast<const double*>(a.xr), static_cast<const double*>(a.xi),
      static_cast<const double*>(a.d1r), static_cast<const double*>(a.d1i),
      static_cast<const double*>(a.twr), static_cast<const double*>(a.twi),
      static_cast<const double*>(a.d2r), static_cast<const double*>(a.d2i),
      static_cast<double*>(a.yr), static_cast<double*>(a.yi), a.rows, a.inverse,
      1.0 / T::N);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* xr, const void* xi, const void* d1r,
               const void* d1i, const void* twr, const void* twi,
               const void* d2r, const void* d2i, void* yr, void* yi,
               long long rows, int n, int inverse, void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  return Args{xr,  xi,  d1r,  d1i,        twr,           twi,
              d2r, d2i, yr,   yi,         rows,          log2n / 2,
              log2n - log2n / 2, inverse, static_cast<cudaStream_t>(stream)};
}

// ---- the f64 mma shapes of sm_90: a throughput probe ----------------------
// Each warp runs `iters` rounds of kChains independent products of one
// shape on register operands; shape 0..3 = m8n8k4, m16n8k4, m16n8k8,
// m16n8k16.  The caller times the launch and divides the flops.
template <int kShape>
struct MmaShape;
template <> struct MmaShape<0> { static constexpr int M = 8, K = 4, A = 1, B = 1, C = 2; };
template <> struct MmaShape<1> { static constexpr int M = 16, K = 4, A = 2, B = 1, C = 4; };
template <> struct MmaShape<2> { static constexpr int M = 16, K = 8, A = 4, B = 2, C = 4; };
template <> struct MmaShape<3> { static constexpr int M = 16, K = 16, A = 8, B = 4, C = 4; };

template <int kShape>
__device__ __forceinline__ void mma_probe(double (&c)[MmaShape<kShape>::C],
                                          const double (&a)[MmaShape<kShape>::A],
                                          const double (&b)[MmaShape<kShape>::B]) {
  if constexpr (kShape == 0) {
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
                 "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
                 : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
  } else if constexpr (kShape == 1) {
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
                 "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  } else if constexpr (kShape == 2) {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  } else {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
                 "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
                   "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
                   "d"(b[2]), "d"(b[3]));
  }
}

template <int kShape, int kChains>
__global__ void mma_rate_kernel(long long iters, double* out) {
  using S = MmaShape<kShape>;
  double a[S::A], b[S::B], c[kChains][S::C];
  const double v = 1e-3 * (1 + (threadIdx.x & 7));
#pragma unroll
  for (int i = 0; i < S::A; ++i) a[i] = v * (i + 1);
#pragma unroll
  for (int i = 0; i < S::B; ++i) b[i] = v / (i + 1);
#pragma unroll
  for (int j = 0; j < kChains; ++j)
#pragma unroll
    for (int i = 0; i < S::C; ++i) c[j][i] = 0.0;
  for (long long it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < kChains; ++j) mma_probe<kShape>(c[j], a, b);
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < kChains; ++j)
#pragma unroll
    for (int i = 0; i < S::C; ++i) s += c[j][i];
  out[static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x] = s;
}

template <int kShape>
int mma_rate_launch(int chains, int blocks, int threads, long long iters,
                    double* out, cudaStream_t stream) {
  switch (chains) {
    case 1: mma_rate_kernel<kShape, 1><<<blocks, threads, 0, stream>>>(iters, out); break;
    case 4: mma_rate_kernel<kShape, 4><<<blocks, threads, 0, stream>>>(iters, out); break;
    case 8: mma_rate_kernel<kShape, 8><<<blocks, threads, 0, stream>>>(iters, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fft_mxu_f32(const void* xr, const void* xi, const void* d1r,
                           const void* d1i, const void* twr, const void* twi,
                           const void* d2r, const void* d2i, void* yr,
                           void* yi, long long rows, int n, int inverse,
                           void* stream) {
  return launch_fma<float>(make_args(xr, xi, d1r, d1i, twr, twi, d2r, d2i, yr,
                                     yi, rows, n, inverse, stream));
}

extern "C" int fft_mxu_f64(const void* xr, const void* xi, const void* d1r,
                           const void* d1i, const void* twr, const void* twi,
                           const void* d2r, const void* d2i, void* yr,
                           void* yi, long long rows, int n, int inverse,
                           void* stream) {
  const Args a = make_args(xr, xi, d1r, d1i, twr, twi, d2r, d2i, yr, yi, rows,
                           n, inverse, stream);
  switch (a.log2n1 + a.log2n2) {
    case 6: return launch_tc<6>(a);
    case 7: return launch_tc<7>(a);
    case 8: return launch_tc<8>(a);
    case 9: return launch_tc<9>(a);
    case 10: return launch_tc<10>(a);
    case 11: return launch_tc<11>(a);
    case 12: return launch_tc<12>(a);
    case 13: return launch_tc<13>(a);
    default:
      return n < 64 ? launch_fma<double>(a) : static_cast<int>(cudaErrorInvalidValue);
  }
}

// The throughput probe: `blocks` x `threads` threads, each warp `iters`
// rounds of `chains` independent products of f64 mma shape `shape`
// (0 m8n8k4, 1 m16n8k4, 2 m16n8k8, 3 m16n8k16); out holds a sum a thread.
extern "C" int fft_mxu_mma_rate(int shape, int chains, int blocks, int threads,
                                long long iters, void* out, void* stream) {
  double* o = static_cast<double*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape) {
    case 0: return mma_rate_launch<0>(chains, blocks, threads, iters, o, s);
    case 1: return mma_rate_launch<1>(chains, blocks, threads, iters, o, s);
    case 2: return mma_rate_launch<2>(chains, blocks, threads, iters, o, s);
    case 3: return mma_rate_launch<3>(chains, blocks, threads, iters, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
