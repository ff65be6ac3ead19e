// Batched radix-2 decimation-in-frequency 1D FFT for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fft_radix2.py:90
// (fft1d_pallas, body _fft_kernel/butterfly_stages) and its inverse
// ifft1d_pallas (fft_radix2.py:143, the conjugate trick).
//
// What it computes, per pencil row of length N = 2^L (2 <= N <= 8192 in
// f64, 16384 in f32; planar re/im, natural order in and out): the L DIF
// butterfly stages of the paper's FFT engine (top = a + b, bottom =
// (a - b) * W, W from the twiddle ROM), then the bit-reversal reorder.
// With `inverse` set, the imaginary part is negated on load, and on store
// the result is scaled by 1/N and its imaginary part negated again:
// ifft(x) = conj(fft(conj(x))) / N.
//
// Bound: memory.  One call reads re/im once and writes re/im once,
// 4*B*N*sizeof(T) bytes, for 5*N*L flops a row -- about 1.4 flop per byte
// in f64, far below the card's ratio -- provided the shared-memory traffic
// stays under the HBM time, which one stage at a time in shared memory
// does not (radix2_stages.cuh counts it).  The design (radix2_stages.cuh,
// shared with the ring payload kernel): three stages a pass in registers,
// so the row crosses shared memory once a pass instead of once a stage;
// an XOR swizzle under which every access, the bit reversal included, is
// free of bank conflicts; the twiddles staged once a block in shared
// memory; several rows a block on a persistent grid that keeps the next
// rows' loads in flight.  Device memory sees one read and one write of
// the data.
//
// C interface (no PyTorch headers, bound with ctypes): each entry point
// launches on the given stream and returns a CUDA error code (0 on
// success).  `twr`/`twi` are the (log2 N, N/2) twiddle ROM; the kernel
// reads its row 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix2_stages.cuh"

namespace {

template <typename T, int L>
__global__ void __launch_bounds__(radix2::Shape<L>::THREADS, 1)
    fft_radix2_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                      const T* __restrict__ twr, const T* __restrict__ twi,
                      T* __restrict__ yr, T* __restrict__ yi, long long rows,
                      int inverse, T scale) {
  radix2::rows<T, L, false>(xr, xi, twr, twi, nullptr, nullptr, yr, yi, rows,
                            inverse, scale);
}

template <typename T>
int launch(const void* xr, const void* xi, const void* twr, const void* twi,
           void* yr, void* yi, long long rows, int n, int inverse,
           void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  return radix2::with_log2n<radix2::max_log2n<T>()>(log2n, [&](auto l) {
    constexpr int L = decltype(l)::value;
    const long long blocks =
        radix2::grid_for<T, L, 0>(fft_radix2_kernel<T, L>, rows);
    if (blocks < 0) return static_cast<int>(-blocks);
    fft_radix2_kernel<T, L><<<static_cast<unsigned>(blocks), radix2::Shape<L>::THREADS,
             radix2::Table<T, L>::smem_bytes(),
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(xr), static_cast<const T*>(xi),
        static_cast<const T*>(twr), static_cast<const T*>(twi),
        static_cast<T*>(yr), static_cast<T*>(yi), rows, inverse,
        static_cast<T>(1.0 / n));
    return static_cast<int>(cudaGetLastError());
  });
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
