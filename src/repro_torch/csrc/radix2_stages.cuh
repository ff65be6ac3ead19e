// The radix-2 DIF butterfly stages of a batch of rows, as register passes:
// the stage code that the radix-2 FFT kernel (fft_radix2.cu) and the ring
// payload kernel (ring_rdma.cu) share, as the JAX package's Pallas kernels
// share butterfly_stages (src/repro/kernels/fft_radix2.py:44).
//
// What it computes.  Per row of n = 2^L planar values, the L stages of the
// paper's DIF engine: stage s pairs a = x[i], b = x[i + half] (half =
// n >> (s+1)) and writes top = a + b, bottom = (a - b) * W, with W the
// twiddle ROM's entry [s, b] -- which is row 0 at stride 2^s, W =
// rom[0, j << s] for j = i & (half - 1) (ref.twiddle_table_np; pinned by
// tests/test_torch_radix2_layout.py) -- then the bit-reversal reorder into
// natural order.  The plain versions (kernels/ref.py::dif_planar,
// ring_rdma.payload_plain) run the same butterflies with the same
// twiddles; only the grouping into passes differs.
//
// What bounds it.  A transform reads and writes each value once: 4 * n *
// sizeof(T) bytes a row for 5 * n * L flops, ~1.4 flop/byte in f64, far
// under the card's ratio.  So HBM bounds it -- if the SM's shared-memory
// pipe keeps up.  A stage-at-a-time row in shared memory does not: nine
// round trips of the row a stage, a 32-way conflicted bit-reversal gather
// and per-butterfly twiddle loads came to ~3040 wavefronts (128 B) a
// 512-point row, 2.5x the HBM time.  The design:
//
//  * Passes of three stages in registers.  In pass p a thread holds the E =
//    8 elements {i0 + (e << q)}, q = max(L - 3 - 3p, 0), e = 0..7 -- the
//    spans of stages 3p, 3p+1, 3p+2 are bits q+2, q+1, q of the index -- and
//    runs their twelve butterflies in registers.  The thread's other L - 3
//    index bits are its group v.  The last pass holds bits 2..0 and runs
//    the one to three stages left.  A 512-point row: 64 threads, 3 passes,
//    the row through shared memory between them.  Rows below 8 points:
//    one thread holds the whole row.
//  * In place, one buffer.  Each pass reads its elements from shared memory
//    (pass 0: from device memory, coalesced: i = v + e * n/8), runs, and
//    writes them back where it read them; one barrier a pass.  The forward
//    output then lies in bit-reversed order, and the natural read is k ->
//    slot of bitrev(k).  In the payload's roundtrip the inverse passes run
//    on the bit-reversed layout (element i at slot of bitrev(i)): they read
//    the forward output in natural order with no reorder of their own, and
//    their own output comes out in natural order.
//  * One XOR swizzle makes every access free of bank conflicts.  A row's
//    element x (its block index (row << L) | i) sits at x ^ F(x >> BB):
//    BB = 4 bank bits for f64 (16 banks of 8 bytes a half-warp), 5 for f32;
//    F is linear over GF(2) (kSwizzleF64/F32, columns for the bits above
//    BB).  The columns were chosen so that, for every L, the BB lowest lane
//    bits of every access -- each pass's elements in both layouts, the
//    natural reads -- map one-to-one onto the banks
//    (tests/test_torch_radix2_layout.py checks it against this table).
//    Linearity makes an address base ^ offset: the base once a thread and
//    pass, the offset of element e a compile-time constant.
//  * Twiddles in shared memory.  Each block stages, once, the ROM's row 0
//    as a tree: stage s's 2^(L-1-s) distinct entries rom[0, j << s] at
//    n - (n >> s) + j, so that lanes read consecutive entries or broadcast
//    one.  Where the tree and the rows do not fit (f64 n = 8192, f32 n =
//    16384) the block keeps row 0 alone and reads it at stride 2^s.
//  * Several rows a block and a persistent grid.  Rows of n <= 2048 share a
//    256-thread block (4 rows at n = 512); larger rows take up to 512
//    threads, each thread then holding n / 4096 groups of 8 a pass.  The
//    grid walks over row sets; while a block of n <= 2048 transforms one
//    set, the pass-0 loads of its next set are in flight in registers.
//
// Wavefronts a 512-point f64 row: 6 shared-memory accesses of the row
// (pass 0 write, pass 1 read and write, pass 2 read and write, natural
// read), each 2 planes x 32 conflict-free wavefronts: 384; twiddles 7
// distinct loads a thread and pass, most of them broadcasts: <= 168.  The
// roundtrip makes 12 accesses (the inverse's pass-0 read takes the place of
// the forward's natural read): 768, and twice the twiddle loads.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace radix2 {

constexpr int kMaxSmemBytes = 232448;  // dynamic shared memory of one block
constexpr int kRowThreads = 512;       // most threads a row
constexpr int kSetThreads = 256;       // a block of rows of n <= 2048

// The pass structure of a row of 2^L points.
template <int L>
struct Shape {
  static constexpr int N = 1 << L;
  static constexpr int EB = L < 3 ? L : 3;  // index bits a thread holds
  static constexpr int E = 1 << EB;         // elements a thread holds
  static constexpr int NG = N / E;          // groups of E a row
  static constexpr int NP = (L + 2) / 3;    // passes
  static constexpr int TROW = NG < kRowThreads ? NG : kRowThreads;
  static constexpr int G = NG / TROW;       // groups a thread
  static constexpr int R = TROW >= kSetThreads ? 1 : kSetThreads / TROW;
  static constexpr int THREADS = R * TROW;
  // the q of pass p: its lowest span bit
  static __host__ __device__ constexpr int q(int p) {
    return L - 3 - 3 * p > 0 ? L - 3 - 3 * p : 0;
  }
};

// Twiddle entries a block keeps: the tree (n - 1), or row 0 alone (n/2).
template <typename T, int L>
struct Table {
  static constexpr int N = 1 << L;
  static constexpr bool kTree =
      (Shape<L>::R * 2 * N + 2 * (N - 1)) * static_cast<int>(sizeof(T)) <=
      kMaxSmemBytes;
  static constexpr int SIZE = kTree ? N - 1 : (N / 2 > 0 ? N / 2 : 1);
  // where entry j of stage s lies
  static __host__ __device__ constexpr int at(int s, int j) {
    return kTree ? N - (N >> s) + j : j << s;
  }
  static constexpr size_t smem_bytes() {
    return (static_cast<size_t>(Shape<L>::R) * 2 * N + 2 * SIZE) * sizeof(T);
  }
};

// The swizzle's columns: bit BB + k of a block index flips these bank bits.
constexpr int kSwizzleCols = 9;
__host__ __device__ constexpr int swizzle_col(int bank_bits, int k) {
  // f64 (bank_bits 4), then f32 (5); see the header comment
  constexpr int kSwizzleF64[kSwizzleCols] = {3, 10, 14, 11, 13, 7, 15, 11, 9};
  constexpr int kSwizzleF32[kSwizzleCols] = {11, 14, 25, 22, 6, 4, 28, 27, 19};
  return bank_bits == 4 ? kSwizzleF64[k] : kSwizzleF32[k];
}

template <typename T>
__host__ __device__ constexpr int bank_bits() {
  return sizeof(T) == 8 ? 4 : 5;
}

// The slot of block index x.
template <typename T>
__host__ __device__ constexpr int swizzle(int x) {
  int f = 0;
#pragma unroll
  for (int k = 0; k < kSwizzleCols; ++k)
    f ^= ((x >> (bank_bits<T>() + k)) & 1) * swizzle_col(bank_bits<T>(), k);
  return x ^ f;
}

template <int L>
__host__ __device__ constexpr int bitrev_c(int x) {
  int y = 0;
  for (int b = 0; b < L; ++b) y |= ((x >> b) & 1) << (L - 1 - b);
  return y;
}

template <int L>
__device__ __forceinline__ int bitrev(int x) {
  return static_cast<int>(__brev(static_cast<unsigned>(x)) >> (32 - L));
}

// Slot of element i of row r: kRev picks the bit-reversed layout.  Split
// as base ^ offset: slot(r, i0 | o) = slot(r, i0) ^ offset(o) for disjoint
// bits, offset a compile-time constant where o is.
template <typename T, int L, bool kRev>
__device__ __forceinline__ int slot(int r, int i) {
  return swizzle<T>((r << L) | (kRev ? bitrev<L>(i) : i));
}
template <typename T, int L, bool kRev>
__host__ __device__ constexpr int offset(int o) {
  return swizzle<T>(kRev ? bitrev_c<L>(o) : o);
}

// A block's shared memory: the data planes of its R rows, then the
// twiddle table's planes.
template <typename T, int L>
struct Smem {
  T* re;
  T* im;
  T* twr;
  T* twi;
  __device__ explicit Smem(unsigned char* raw) {
    constexpr int span = Shape<L>::R * Shape<L>::N;
    re = reinterpret_cast<T*>(raw);
    im = re + span;
    twr = im + span;
    twi = twr + Table<T, L>::SIZE;
  }
};

// Stage the twiddle table from the ROM's row 0 (rom[0, m] at m): one flat
// loop of independent loads, entry idx of the tree being stage s's j.
// The caller passes a barrier before the table is read.
template <typename T, int L>
__device__ __forceinline__ void load_twiddles(const Smem<T, L>& sm,
                                              const T* __restrict__ rom_r,
                                              const T* __restrict__ rom_i) {
  using Tab = Table<T, L>;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < Tab::SIZE; idx += blockDim.x) {
    int src = idx;
    if (Tab::kTree) {
      // stage s holds entries [n - (n >> s), n - (n >> (s+1))): n - 1 - idx
      // lies in [2^(L-s-1), 2^(L-s))
      const int s = L - 1 - (31 - __clz(Tab::N - 1 - idx));
      src = (idx - (Tab::N - (Tab::N >> s))) << s;
    }
    sm.twr[idx] = rom_r[src];
    sm.twi[idx] = rom_i[src];
  }
}

// The butterflies of stage S on the E elements of group v in pass P.
template <typename T, int L, int P, int S>
__device__ __forceinline__ void stage(T (&xr)[Shape<L>::E],
                                      T (&xi)[Shape<L>::E],
                                      const Smem<T, L>& sm, int v) {
  using Sh = Shape<L>;
  constexpr int Q = Sh::q(P);
  constexpr int M = (L - 1 - S) - Q;  // the element bit of the span
  // W for butterfly (e, e | 1 << M): j = v's bits below Q, then e's below M
  const int jv = v & ((1 << Q) - 1);
  T wr[1 << M], wi[1 << M];
#pragma unroll
  for (int el = 0; el < (1 << M); ++el) {
    const int at = Table<T, L>::at(S, jv | (el << Q));
    wr[el] = sm.twr[at];
    wi[el] = sm.twi[at];
  }
#pragma unroll
  for (int e = 0; e < Sh::E; ++e) {
    if (e & (1 << M)) continue;
    const int f = e | (1 << M), el = e & ((1 << M) - 1);
    const T ar = xr[e], ai = xi[e], br = xr[f], bi = xi[f];
    const T dr = ar - br, di = ai - bi;
    xr[e] = ar + br;
    xi[e] = ai + bi;
    xr[f] = dr * wr[el] - di * wi[el];
    xi[f] = dr * wi[el] + di * wr[el];
  }
}

// Stages 3P .. 3P+2 (those below L) on one group.
template <typename T, int L, int P>
__device__ __forceinline__ void pass(T (&xr)[Shape<L>::E], T (&xi)[Shape<L>::E],
                                     const Smem<T, L>& sm, int v) {
  stage<T, L, P, 3 * P>(xr, xi, sm, v);
  if constexpr (3 * P + 1 < L) stage<T, L, P, 3 * P + 1>(xr, xi, sm, v);
  if constexpr (3 * P + 2 < L) stage<T, L, P, 3 * P + 2>(xr, xi, sm, v);
}

// Index of element 0 of group v in pass P (element e adds e << q(P)).
template <int L, int P>
__device__ __forceinline__ int first_index(int v) {
  constexpr int Q = Shape<L>::q(P);
  return ((v >> Q) << (Q + Shape<L>::EB)) | (v & ((1 << Q) - 1));
}

// Group v's pass-P elements from / to shared memory in layout kRev.
template <typename T, int L, int P, bool kRev>
__device__ __forceinline__ void read_group(T (&xr)[Shape<L>::E],
                                           T (&xi)[Shape<L>::E],
                                           const Smem<T, L>& sm, int r, int v) {
  const int base = slot<T, L, kRev>(r, first_index<L, P>(v));
#pragma unroll
  for (int e = 0; e < Shape<L>::E; ++e) {
    const int at = base ^ offset<T, L, kRev>(e << Shape<L>::q(P));
    xr[e] = sm.re[at];
    xi[e] = sm.im[at];
  }
}
template <typename T, int L, int P, bool kRev>
__device__ __forceinline__ void write_group(const T (&xr)[Shape<L>::E],
                                            const T (&xi)[Shape<L>::E],
                                            const Smem<T, L>& sm, int r, int v) {
  const int base = slot<T, L, kRev>(r, first_index<L, P>(v));
#pragma unroll
  for (int e = 0; e < Shape<L>::E; ++e) {
    const int at = base ^ offset<T, L, kRev>(e << Shape<L>::q(P));
    sm.re[at] = xr[e];
    sm.im[at] = xi[e];
  }
}

// Passes P.. of a row set, reading and writing shared memory in place, a
// barrier after each.
template <typename T, int L, int P, bool kRev>
__device__ __forceinline__ void smem_passes(const Smem<T, L>& sm, int r, int t) {
  using Sh = Shape<L>;
  if constexpr (P < Sh::NP) {
#pragma unroll 1
    for (int g = 0; g < Sh::G; ++g) {
      const int v = t + g * Sh::TROW;
      T xr[Sh::E], xi[Sh::E];
      read_group<T, L, P, kRev>(xr, xi, sm, r, v);
      pass<T, L, P>(xr, xi, sm, v);
      write_group<T, L, P, kRev>(xr, xi, sm, r, v);
    }
    __syncthreads();
    smem_passes<T, L, P + 1, kRev>(sm, r, t);
  }
}

// All passes of a row set in layout kRev: pass 0's elements of each group
// come from first(g, v, xr, xi) (natural indices v + e * NG), the later
// passes' from shared memory.  Ends with the transform in the buffer and
// a barrier passed.
template <typename T, int L, bool kRev, typename First>
__device__ __forceinline__ void dif_passes(const Smem<T, L>& sm, int r, int t,
                                           First first) {
  using Sh = Shape<L>;
#pragma unroll 1
  for (int g = 0; g < Sh::G; ++g) {
    const int v = t + g * Sh::TROW;
    T xr[Sh::E], xi[Sh::E];
    first(g, v, xr, xi);
    pass<T, L, 0>(xr, xi, sm, v);
    write_group<T, L, 0, kRev>(xr, xi, sm, r, v);
  }
  __syncthreads();
  smem_passes<T, L, 1, kRev>(sm, r, t);
}

// Natural index k of the transform that passes in layout kRev left in the
// buffer, for k = v + e * NG: out(k, re, im) per element, coalesced.  The
// forward layout's output lies bit-reversed (read at bitrev(k)), the
// bit-reversed layout's in natural order.
template <typename T, int L, bool kRev, typename Out>
__device__ __forceinline__ void read_natural(const Smem<T, L>& sm, int r, int t,
                                             Out out) {
  using Sh = Shape<L>;
#pragma unroll 1
  for (int g = 0; g < Sh::G; ++g) {
    const int v = t + g * Sh::TROW;
    const int base = slot<T, L, !kRev>(r, v);
#pragma unroll
    for (int e = 0; e < Sh::E; ++e) {
      const int at = base ^ offset<T, L, !kRev>(e * Sh::NG);
      out(v + e * Sh::NG, sm.re[at], sm.im[at]);
    }
  }
}

// Group v's pass-0 elements of row `row` (natural indices v + e * NG) from
// device memory, zeros past the last row.
template <typename T, int L>
__device__ __forceinline__ void load_group(T (&xr)[Shape<L>::E],
                                           T (&xi)[Shape<L>::E],
                                           const T* __restrict__ gr,
                                           const T* __restrict__ gi,
                                           long long row, long long rows, int v) {
  using Sh = Shape<L>;
  const size_t base = static_cast<size_t>(row) * Sh::N + v;
#pragma unroll
  for (int e = 0; e < Sh::E; ++e) {
    xr[e] = row < rows ? gr[base + e * Sh::NG] : T(0);
    xi[e] = row < rows ? gi[base + e * Sh::NG] : T(0);
  }
}

// The whole batched transform: `rows` rows of x (planar, contiguous) into
// y, the ROM's row 0 at (rom_r, rom_i), diag only in roundtrip mode.  One
// block a row set at a time, the grid walking the sets; pass 0's loads of
// the next set are in flight while a set is transformed (n <= 2048).
template <typename T, int L, bool kRoundtrip>
__device__ __forceinline__ void rows(const T* __restrict__ xr,
                                     const T* __restrict__ xi,
                                     const T* __restrict__ rom_r,
                                     const T* __restrict__ rom_i,
                                     const T* __restrict__ dr,
                                     const T* __restrict__ di,
                                     T* __restrict__ yr, T* __restrict__ yi,
                                     long long nrows, int inverse, T scale) {
  using Sh = Shape<L>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T, L> sm(smem_raw);
  const int r = threadIdx.x / Sh::TROW, t = threadIdx.x % Sh::TROW;
  const long long sets = (nrows + Sh::R - 1) / Sh::R;
  // a 512-thread block has 128 registers a thread: no room for the next
  // set's elements beside the current ones
  constexpr bool kPrefetch = Sh::G == 1 && Sh::THREADS <= kSetThreads;
  T nr[Sh::E], ni[Sh::E];
  if constexpr (kPrefetch)  // the first set's loads fly while the table loads
    load_group<T, L>(nr, ni, xr, xi, static_cast<long long>(blockIdx.x) * Sh::R + r,
                     nrows, t);
  load_twiddles<T, L>(sm, rom_r, rom_i);
  __syncthreads();
  for (long long set = blockIdx.x; set < sets; set += gridDim.x) {
    const long long row = set * Sh::R + r;
    const size_t row0 = static_cast<size_t>(row) * Sh::N;
    T cr[Sh::E], ci[Sh::E];
    if constexpr (kPrefetch) {
#pragma unroll
      for (int e = 0; e < Sh::E; ++e) {
        cr[e] = nr[e];
        ci[e] = ni[e];
      }
      load_group<T, L>(nr, ni, xr, xi, row + static_cast<long long>(gridDim.x) * Sh::R,
                       nrows, t);
    }
    dif_passes<T, L, false>(sm, r, t, [&](int g, int v, T(&ar)[Sh::E], T(&ai)[Sh::E]) {
      if constexpr (kPrefetch) {
#pragma unroll
        for (int e = 0; e < Sh::E; ++e) {
          ar[e] = cr[e];
          ai[e] = ci[e];
        }
      } else {
        load_group<T, L>(ar, ai, xr, xi, row, nrows, v);
      }
      if (inverse) {
#pragma unroll
        for (int e = 0; e < Sh::E; ++e) ai[e] = -ai[e];
      }
    });
    if constexpr (kRoundtrip) {
      // the inverse passes on the bit-reversed layout: pass 0 reads the
      // forward output in natural order, times diag, conjugated
      dif_passes<T, L, true>(sm, r, t, [&](int, int v, T(&ar)[Sh::E], T(&ai)[Sh::E]) {
        T pr[Sh::E], pi[Sh::E];
        load_group<T, L>(pr, pi, dr, di, row, nrows, v);
        read_group<T, L, 0, true>(ar, ai, sm, r, v);
#pragma unroll
        for (int e = 0; e < Sh::E; ++e) {
          const T a = ar[e], b = ai[e];
          ar[e] = a * pr[e] - b * pi[e];
          ai[e] = -(a * pi[e] + b * pr[e]);
        }
      });
    }
    const bool store = row < nrows;
    const bool conj_out = kRoundtrip || inverse;
    read_natural<T, L, kRoundtrip>(sm, r, t, [&](int k, T a, T b) {
      if (!store) return;
      if (conj_out) {
        yr[row0 + k] = a * scale;
        yi[row0 + k] = -(b * scale);
      } else {
        yr[row0 + k] = a;
        yi[row0 + k] = b;
      }
    });
    __syncthreads();  // the buffer is free for the next set
  }
}

// Launch kernel<L>(args...) on a persistent grid for a runtime log2 n in
// [1, kMaxL]: at most as many blocks as fit on the card at once.
template <int kMaxL, typename F>
int with_log2n(int log2n, F&& f) {
  switch (log2n) {
#define RADIX2_CASE(l) \
  case l:              \
    if constexpr (l <= kMaxL) return f(std::integral_constant<int, l>{}); \
    break;
    RADIX2_CASE(1) RADIX2_CASE(2) RADIX2_CASE(3) RADIX2_CASE(4)
    RADIX2_CASE(5) RADIX2_CASE(6) RADIX2_CASE(7) RADIX2_CASE(8)
    RADIX2_CASE(9) RADIX2_CASE(10) RADIX2_CASE(11) RADIX2_CASE(12)
    RADIX2_CASE(13) RADIX2_CASE(14)
#undef RADIX2_CASE
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The largest log2 n a row of T may have (shared memory).
template <typename T>
constexpr int max_log2n() {
  return sizeof(T) == 8 ? 13 : 14;
}

// Grid of a launch of `kernel` (a kernel running rows<T, L, ...>; kTag
// tells kernels of one signature apart) over `nrows` rows: at most as many
// blocks as fit on the card at once.  Sets the kernel's shared-memory
// limit first; both are done once a device.  Returns the number of
// blocks, or minus a CUDA error.
template <typename T, int L, int kTag, typename K>
long long grid_for(K kernel, long long nrows) {
  static int cached_dev = -1;
  static long long resident = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  if (dev != cached_dev) {
    const size_t smem = Table<T, L>::smem_bytes();
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, Shape<L>::THREADS, smem)) != cudaSuccess)
      return -static_cast<long long>(err);
    if (per_sm < 1) return -static_cast<long long>(cudaErrorInvalidConfiguration);
    resident = static_cast<long long>(sms) * per_sm;
    cached_dev = dev;
  }
  const long long sets = (nrows + Shape<L>::R - 1) / Shape<L>::R;
  return sets < resident ? sets : resident;
}

}  // namespace radix2
