// The radix-2 DIF butterfly stages on one row in shared memory: the stage
// code that the radix-2 FFT kernel (fft_radix2.cu) and the ring payload
// kernel (ring_rdma.cu) share, as the JAX package's Pallas kernels share
// butterfly_stages (src/repro/kernels/fft_radix2.py:44).
//
// One thread block owns one row of n = 2^log2n planar values (sr, si) in
// shared memory.  Stage s pairs a = x[ia], b = x[ia + half] and writes
// top = a + b, bottom = (a - b) * W, W read from entry [s, b] of the
// (log2 N, N/2) twiddle ROM (twr, twi).  After the last stage the row is
// in bit-reversed order: natural bin k sits at bitrev(k).

#pragma once

namespace radix2 {

// Natural bin k of a bit-reversed row of 2^log2n values lies at this index
// (the bit reversal is an involution, so the converse holds too).
__device__ __forceinline__ int bitrev(int k, int log2n) {
  return static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - log2n));
}

// All log2n stages, a __syncthreads() after each.  Expects the row loaded
// and a barrier passed before the call.
template <typename T>
__device__ __forceinline__ void dif_stages(T* sr, T* si,
                                           const T* __restrict__ twr,
                                           const T* __restrict__ twi, int n,
                                           int log2n) {
  const int halfn = n >> 1;
  for (int s = 0; s < log2n; ++s) {
    const int shift = log2n - s - 1;  // half = 2^shift butterfly span
    const int half = 1 << shift;
    const T* wr_row = twr + static_cast<size_t>(s) * halfn;
    const T* wi_row = twi + static_cast<size_t>(s) * halfn;
    for (int b = threadIdx.x; b < halfn; b += blockDim.x) {
      const int g = b >> shift;            // butterfly group
      const int j = b & (half - 1);        // position inside the group
      const int ia = (g << (shift + 1)) + j;
      const int ib = ia + half;
      const T ar = sr[ia], ai = si[ia];
      const T br = sr[ib], bi = si[ib];
      const T dr = ar - br, di = ai - bi;
      const T wr = wr_row[b], wi = wi_row[b];
      sr[ia] = ar + br;
      si[ia] = ai + bi;
      sr[ib] = dr * wr - di * wi;
      si[ib] = dr * wi + di * wr;
    }
    __syncthreads();
  }
}

// Threads per row block: one per butterfly, at most 256.
__host__ __device__ inline int threads_for(int n) {
  return (n / 2 < 256) ? n / 2 : 256;
}

}  // namespace radix2
