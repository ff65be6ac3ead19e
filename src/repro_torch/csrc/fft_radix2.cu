// Batched radix-2 decimation-in-frequency 1D FFT for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fft_radix2.py:90
// (fft1d_pallas, body _fft_kernel/butterfly_stages) and its inverse
// ifft1d_pallas (fft_radix2.py:143, the conjugate trick).
//
// What it computes, per pencil row of length N (a power of two, planar
// re/im): the log2(N) DIF butterfly stages of the paper's FFT engine
// (top = a + b, bottom = (a - b) * W), with the stage-s twiddle of butterfly
// b read from entry [s, b] of the (log2 N, N/2) twiddle ROM, then the
// bit-reversal reorder y[k] = x[bitrev(k)] into natural order.  With
// `inverse` set, the imaginary part is negated on load, and on store the
// result is scaled by 1/N and its imaginary part negated again:
// ifft(x) = conj(fft(conj(x))) / N.
//
// Bound: memory.  One call reads re/im once and writes re/im once,
// 4*B*N*sizeof(T) bytes, for 5*N*log2(N) flops per row -- about 1.4 flop
// per byte in f64, far below the card's ratio of peak flops to bandwidth.
// So the design keeps every stage in shared memory: one thread block owns
// one row, loads it once with coalesced reads, runs all log2(N) stages on
// the 2*N*sizeof(T) bytes of dynamic shared memory (__syncthreads between
// stages), and writes it once through the bit-reversal gather.  Device
// memory sees exactly one read and one write of the data.  The stages
// themselves are radix2_stages.cuh, shared with the ring payload kernel.
//
// C interface (no PyTorch headers, bound with ctypes): each entry point
// launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix2_stages.cuh"

namespace {

template <typename T>
__global__ void fft_radix2_kernel(const T* __restrict__ xr,
                                  const T* __restrict__ xi,
                                  const T* __restrict__ twr,
                                  const T* __restrict__ twi,
                                  T* __restrict__ yr, T* __restrict__ yi,
                                  int n, int log2n, int inverse, T scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sr = reinterpret_cast<T*>(smem_raw);
  T* si = sr + n;

  const size_t base = static_cast<size_t>(blockIdx.x) * static_cast<size_t>(n);
  const T* rr = xr + base;
  const T* ri = xi + base;

  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    sr[k] = rr[k];
    si[k] = inverse ? -ri[k] : ri[k];
  }
  __syncthreads();

  radix2::dif_stages(sr, si, twr, twi, n, log2n);

  T* outr = yr + base;
  T* outi = yi + base;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int src = radix2::bitrev(k, log2n);
    if (inverse) {
      outr[k] = sr[src] * scale;
      outi[k] = -si[src] * scale;
    } else {
      outr[k] = sr[src];
      outi[k] = si[src];
    }
  }
}

template <typename T>
int launch(const void* xr, const void* xi, const void* twr, const void* twi,
           void* yr, void* yi, long long rows, int n, int inverse,
           void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  const size_t smem = 2u * static_cast<size_t>(n) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      fft_radix2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = radix2::threads_for(n);
  fft_radix2_kernel<T><<<static_cast<unsigned>(rows), threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<const T*>(twr), static_cast<const T*>(twi),
      static_cast<T*>(yr), static_cast<T*>(yi), n, log2n, inverse,
      static_cast<T>(1.0 / n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fft_radix2_f32(const void* xr, const void* xi, const void* twr,
                              const void* twi, void* yr, void* yi,
                              long long rows, int n, int inverse,
                              void* stream) {
  return launch<float>(xr, xi, twr, twi, yr, yi, rows, n, inverse, stream);
}

extern "C" int fft_radix2_f64(const void* xr, const void* xi, const void* twr,
                              const void* twi, void* yr, void* yi,
                              long long rows, int n, int inverse,
                              void* stream) {
  return launch<double>(xr, xi, twr, twi, yr, yi, rows, n, inverse, stream);
}
