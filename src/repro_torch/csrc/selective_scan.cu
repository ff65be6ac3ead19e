// Mamba's selective scan (S6), hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference runs the recurrence as a
// lax.scan (src/repro/models/mamba.py:102 is the step, :113
// chunked_time_scan runs it over the prompt, :123 mamba_step is the
// decode).  A scan on the hot path becomes a kernel here: as a Python loop
// of torch ops it would be ~6 launches a step, ~86 k for one prefill of a
// Jamba superblock's 7 Mamba layers at a 2048-token prompt.  This kernel
// takes one launch a layer, for any number of steps S >= 1: the prefill at
// S = the prompt, a decode step at S = 1.
//
// What it computes, for each batch row b and channel d, with the state
// h[d, :] (DS values) in f32 and a[d, :] = -exp(A_log[d, :]):
//
//   h[s] <- exp(dt[t, d] a[s]) h[s] + (dt[t, d] x[t, d]) B[t, s]
//   y[t, d] = sum_s h[s] C[t, s] + x[t, d] D[d]
//
// the reference's step (mamba.py:102-106) and its D skip (:109), folded in
// here so that y leaves the kernel once.  dt (B, S, DI) f32, x (B, S, DI)
// in the compute dtype (f32 or bf16, upcast in registers: exact, as the
// reference casts xc), B and C (B, S, DS) f32, A_log (DI, DS) f32, D (DI)
// f32, the state (B, DI, DS) f32; y (B, S, DI) f32 and the final state
// (B, DI, DS) f32 are written.  All contiguous.  DS, the state size, is a
// template parameter: 8 (jamba's SMOKE config) and 16 (jamba-1.5-large).
//
// What bounds it.  At the Jamba prefill (B = 8, S = 2048, DI = 16384,
// DS = 16, bf16 x) the work is 4.295e9 state-element steps.  Bytes: dt and
// y (2 x 1.074 GB), x (0.537 GB), B, C (2 x 1.05 MB), A_log, D and the state
// in and out (2 x 8.4 MB), 2.70 GB, 0.81 ms at 3.35 TB/s.  Flops: 6 f32
// flops a state element a step (dt a: 1; (dt x) B: 1; exp() h + that: 2;
// h C summed: 2) and 3 a (step, channel) (dt x: 1; x D added: 2), 26.6
// GFLOP, 0.40 ms at 67 TFLOP/s.  And one exp a state element a step:
// 4.295e9 on the special function units alone (ex2, 16 a clock an SM on
// compute capability 9.0, 132 SMs at 1.98 GHz) take 1.03 ms, but a part
// of them may run as a polynomial on the FMA pipes (about 8 instructions
// each), beside the flops there: levelled, the arithmetic takes 0.71 ms.
// So the bytes bound it, 0.81 ms.  At S = 1 (a decode step) the state's
// bytes bound it (16.8 MB at B = 8: 19.2 MB with x, dt, y, B, C, A_log
// and D, 5.7 us).
//
// Design (simple first): a thread owns one (b, d) channel, its DS values
// of h and of a (pre-scaled by log2 e, so each step's exp is one ex2) in
// registers; nothing is exchanged between threads.  A block of CH = 128
// channels of one row stages the B and C rows of CHUNK steps, which all
// its channels read, in shared memory (broadcast reads, float4), two
// barriers a chunk.  dt and x are read coalesced across d, the next
// step's loads issued before the current step's chain.  1024 blocks at the
// prefill shape, one wave of 8 blocks an SM; 128 blocks at B = 1.  Every
// step's arithmetic is the same wherever a call cuts the sequence, so a
// prompt in two calls with the state carried gives the whole prompt's bits.
//
// C interface (no PyTorch headers, bound with ctypes): launches on the
// given stream and returns a CUDA error code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 128;     // channels a block, one a thread
constexpr int CHUNK = 64;   // steps whose B and C rows are staged at a time
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 2^x on the special function unit
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one state element of one step: decay, input, and its term of y
__device__ __forceinline__ void element(float& h, float& acc, float a2,
                                        float dtv, float dtx, float bs,
                                        float cs) {
  h = fmaf(ex2(dtv * a2), h, dtx * bs);
  acc = fmaf(h, cs, acc);
}

template <typename T, int DS>
__global__ void __launch_bounds__(CH)
    selective_scan_kernel(const float* __restrict__ dt, const T* __restrict__ x,
                          const float* __restrict__ bm, const float* __restrict__ cm,
                          const float* __restrict__ a_log,
                          const float* __restrict__ dskip, const float* h_in,
                          float* __restrict__ y, float* h_out, int S, int DI) {
  static_assert(DS % 4 == 0, "a state row is read as float4");
  __shared__ __align__(16) float bs[CHUNK][DS];
  __shared__ __align__(16) float cs[CHUNK][DS];

  const int b = blockIdx.y;
  const int d = blockIdx.x * CH + threadIdx.x;
  const bool live = d < DI;

  float a2[DS], h[DS];
  float dd = 0.f;
  const long long state = (static_cast<long long>(b) * DI + d) * DS;
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a2[s] = live ? -expf(a_log[static_cast<long long>(d) * DS + s]) * LOG2E : 0.f;
    h[s] = live ? h_in[state + s] : 0.f;
  }
  if (live) dd = dskip[d];

  const long long row0 = static_cast<long long>(b) * S;  // (b, t = 0)
  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const int n = min(CHUNK, S - t0);
    __syncthreads();  // the previous chunk's reads are done
    const long long src = (row0 + t0) * DS;
    for (int i = threadIdx.x; i < n * DS; i += CH) {
      (&bs[0][0])[i] = bm[src + i];
      (&cs[0][0])[i] = cm[src + i];
    }
    __syncthreads();
    if (!live) continue;
    const long long base = (row0 + t0) * DI + d;
    float dtn = dt[base];
    float xn = to_f32(x[base]);
    for (int c = 0; c < n; ++c) {
      const float dtv = dtn, xv = xn;
      if (c + 1 < n) {  // the next step's loads, ahead of this step's chain
        const long long next = base + static_cast<long long>(c + 1) * DI;
        dtn = dt[next];
        xn = to_f32(x[next]);
      }
      const float dtx = dtv * xv;
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < DS; s += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&bs[c][s]);
        const float4 c4 = *reinterpret_cast<const float4*>(&cs[c][s]);
        element(h[s + 0], acc, a2[s + 0], dtv, dtx, b4.x, c4.x);
        element(h[s + 1], acc, a2[s + 1], dtv, dtx, b4.y, c4.y);
        element(h[s + 2], acc, a2[s + 2], dtv, dtx, b4.z, c4.z);
        element(h[s + 3], acc, a2[s + 3], dtv, dtx, b4.w, c4.w);
      }
      y[base + static_cast<long long>(c) * DI] = fmaf(xv, dd, acc);
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < DS; ++s) h_out[state + s] = h[s];
  }
}

template <typename T, int DS>
int launch(const void* dt, const void* x, const void* bm, const void* cm,
           const void* a_log, const void* dskip, const void* h_in, void* y,
           void* h_out, int B, int S, int DI, cudaStream_t stream) {
  const dim3 grid((DI + CH - 1) / CH, B);
  selective_scan_kernel<T, DS><<<grid, CH, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a_log), static_cast<const float*>(dskip),
      static_cast<const float*>(h_in), static_cast<float*>(y),
      static_cast<float*>(h_out), S, DI);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* dt, const void* x, const void* bm, const void* cm,
             const void* a_log, const void* dskip, const void* h_in, void* y,
             void* h_out, int B, int S, int DI, int DS, cudaStream_t stream) {
  switch (DS) {
    case 8:
      return launch<T, 8>(dt, x, bm, cm, a_log, dskip, h_in, y, h_out, B, S, DI, stream);
    case 16:
      return launch<T, 16>(dt, x, bm, cm, a_log, dskip, h_in, y, h_out, B, S, DI, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 for f32 x; 1 for bf16.  B rows at most 65535 (the grid's y)
extern "C" int selective_scan_fwd(const void* dt, const void* x, const void* bm,
                                  const void* cm, const void* a_log, const void* dskip,
                                  const void* h_in, void* y, void* h_out, int B, int S,
                                  int DI, int DS, int dtype, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || S <= 0 || DI <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(dt, x, bm, cm, a_log, dskip, h_in, y, h_out, B, S, DI, DS,
                           stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(dt, x, bm, cm, a_log, dskip, h_in, y, h_out, B, S,
                                   DI, DS, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
