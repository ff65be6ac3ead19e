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
// (3.35 TB/s).  On the tensor cores the two are close and bytes bound it; on
// the FP64 CUDA cores (34 TFLOP/s) the flops would.  So in f64 the products
// run as mma.sync m8n8k4 (DMMA), and the design keeps the data out of device
// memory between the steps: one thread block owns one row, loads it once
// (coalesced) into shared memory, runs steps 1-3 there, stages D in output
// order in the same buffer and writes it once (coalesced).  The transposed
// store of step 4 becomes a scatter inside shared memory.
//
// Tensor-core path (f64, N >= 64).  Each warp owns TPW 8x8 output tiles of
// one column strip; for steps 1 and 3 its lanes hold the complex result in
// registers (a re and an im accumulator, two values a lane), so A can be
// overwritten by C, and C by D, after a barrier.  The tables are read
// through the read-only cache (__ldg): the whole plan is 28 KB at N=512,
// shared by all blocks on an SM, but 448 KB at N=8192 -- more than a
// block's shared memory -- so they are not staged.  Rows of A/C carry a pad
// of 4 doubles, which makes the fragment reads of shared memory free of
// bank conflicts.
//
// CUDA-core path (f32 at every N, f64 below N = 64, where n1 < 8 leaves no
// 8x8x4 tile; N = 2 is n1 = 1, n2 = 2): a full-precision FMA loop, one
// output element a thread, with
// A and C in separate shared buffers.  f32 deliberately avoids TF32, which
// keeps ~3 digits.
//
// C interface (no PyTorch headers, bound with ctypes): each entry point
// launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 4;  // doubles of padding per row of A/C (tensor cores)

__device__ __forceinline__ void dmma(double& c0, double& c1, double a,
                                     double b) {
  // D(8x8) += A(8x4, row) * B(4x8, col); lane l holds A[l/4][l%4],
  // B[l%4][l/4] and D[l/4][2*(l%4) + {0,1}]
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

template <int TPW>
__global__ void __launch_bounds__(1024) fft_mxu_tc_kernel(
    const double* __restrict__ xr, const double* __restrict__ xi,
    const double* __restrict__ d1r, const double* __restrict__ d1i,
    const double* __restrict__ twr, const double* __restrict__ twi,
    const double* __restrict__ d2r, const double* __restrict__ d2i,
    double* __restrict__ yr, double* __restrict__ yi, int log2n1,
    int log2n2, int inverse, double scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n1 = 1 << log2n1, n2 = 1 << log2n2, n = n1 * n2;
  const int ld = n2 + kPad;
  double* sr = reinterpret_cast<double*>(smem_raw);
  double* si = sr + n1 * ld;
  const size_t base = static_cast<size_t>(blockIdx.x) * static_cast<size_t>(n);

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int s = (j >> log2n2) * ld + (j & (n2 - 1));
    sr[s] = xr[base + j];
    const double v = xi[base + j];
    si[s] = inverse ? -v : v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = n2 >> 3;
  const int nt = warp % ntiles;           // the warp's column tile
  const int mt0 = (warp / ntiles) * TPW;  // its first row tile
  const int bcol = nt * 8 + g;            // this lane's B-operand column
  double accr[TPW][2], acci[TPW][2];

  // step 1: B = d1 @ A
#pragma unroll
  for (int i = 0; i < TPW; ++i)
    accr[i][0] = accr[i][1] = acci[i][0] = acci[i][1] = 0.0;
#pragma unroll 4
  for (int kk = 0; kk < n1; kk += 4) {
    const int k = kk + t;
    const double bR = sr[k * ld + bcol], bI = si[k * ld + bcol];
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int row = (mt0 + i) * 8 + g;
      const double aR = __ldg(d1r + row * n1 + k);
      const double aI = __ldg(d1i + row * n1 + k);
      dmma(accr[i][0], accr[i][1], aR, bR);
      dmma(accr[i][0], accr[i][1], -aI, bI);
      dmma(acci[i][0], acci[i][1], aR, bI);
      dmma(acci[i][0], acci[i][1], aI, bR);
    }
  }
  __syncthreads();  // every warp has read A

  // step 2: C = B o tw, written over A
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int row = (mt0 + i) * 8 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = nt * 8 + 2 * t + h;
      const double wr = __ldg(twr + row * n2 + c);
      const double wi = __ldg(twi + row * n2 + c);
      const double br = accr[i][h], bi = acci[i][h];
      sr[row * ld + c] = br * wr - bi * wi;
      si[row * ld + c] = br * wi + bi * wr;
    }
  }
  __syncthreads();

  // step 3: D = C @ d2
#pragma unroll
  for (int i = 0; i < TPW; ++i)
    accr[i][0] = accr[i][1] = acci[i][0] = acci[i][1] = 0.0;
#pragma unroll 4
  for (int kk = 0; kk < n2; kk += 4) {
    const int k = kk + t;
    const double bR = __ldg(d2r + k * n2 + bcol);
    const double bI = __ldg(d2i + k * n2 + bcol);
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int row = (mt0 + i) * 8 + g;
      const double aR = sr[row * ld + k], aI = si[row * ld + k];
      dmma(accr[i][0], accr[i][1], aR, bR);
      dmma(accr[i][0], accr[i][1], -aI, bI);
      dmma(acci[i][0], acci[i][1], aR, bI);
      dmma(acci[i][0], acci[i][1], aI, bR);
    }
  }
  __syncthreads();  // every warp has read C

  // step 4: D staged in output order, X[k1 + n1*k2] = D[k1][k2]
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int k1 = (mt0 + i) * 8 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k2 = nt * 8 + 2 * t + h;
      sr[k1 + (k2 << log2n1)] = accr[i][h];
      si[k1 + (k2 << log2n1)] = acci[i][h];
    }
  }
  __syncthreads();

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    if (inverse) {
      yr[base + j] = sr[j] * scale;
      yi[base + j] = -si[j] * scale;
    } else {
      yr[base + j] = sr[j];
      yi[base + j] = si[j];
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

template <int TPW>
int launch_tc(const Args& a) {
  const int n1 = 1 << a.log2n1, n2 = 1 << a.log2n2;
  const int warps = (n1 / 8) * (n2 / 8) / TPW;
  const size_t smem =
      2u * static_cast<size_t>(n1) * (n2 + kPad) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      fft_mxu_tc_kernel<TPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fft_mxu_tc_kernel<TPW><<<static_cast<unsigned>(a.rows), warps * 32, smem,
                           a.stream>>>(
      static_cast<const double*>(a.xr), static_cast<const double*>(a.xi),
      static_cast<const double*>(a.d1r), static_cast<const double*>(a.d1i),
      static_cast<const double*>(a.twr), static_cast<const double*>(a.twi),
      static_cast<const double*>(a.d2r), static_cast<const double*>(a.d2i),
      static_cast<double*>(a.yr), static_cast<double*>(a.yi), a.log2n1,
      a.log2n2, a.inverse, 1.0 / (n1 * n2));
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
  if (n < 64) return launch_fma<double>(a);
  const int tiles = n / 64;  // 8x8 output tiles of an n1 x n2 product
  switch (tiles <= 32 ? 1 : tiles / 32) {  // at most 32 warps a block
    case 1: return launch_tc<1>(a);
    case 2: return launch_tc<2>(a);
    case 4: return launch_tc<4>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
