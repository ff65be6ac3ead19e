// RWKV-6 ("Finch") WKV recurrence, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference runs this recurrence as a
// lax.scan (src/repro/models/rwkv.py:90, rwkv_time_mix_seq, through
// repro.models.mamba.chunked_time_scan; one step is rwkv_time_mix_step
// :61).  A scan on the hot path becomes a kernel here: as a Python loop
// of torch ops it would be ~6 launches a step, ~393 k for one prefill of
// rwkv6-3b at a 2048-token prompt.  This kernel takes one launch a layer,
// for any number of steps S >= 1: the prefill at S = the prompt, a decode
// step at S = 1.
//
// What it computes, for each batch row b and head h, with the K x K state
// s (row i indexes k's channel, column j v's), all in f32:
//
//   y[t, j] = sum_i r[t, i] * (s[i, j] + u[i] * k[t, i] * v[t, j])
//   s[i, j] <- w[t, i] * s[i, j] + k[t, i] * v[t, j]
//
// y is read from the old state plus the bonus u (.) k v^T, before the decay
// updates the state, as the reference's step does.  r, k, v are
// (B, S, H, K) in the compute dtype (f32 or bf16: upcast in registers,
// which is exact), w (B, S, H, K) f32, u (H, K) f32, the state
// (B, H, K, K) f32; y (B, S, H, K) f32 and the final state (B, H, K, K)
// f32 are written.  All contiguous.  K, the head size, is a template
// parameter: 16 (rwkv6-3b's SMOKE config) and 64 (rwkv6-3b).
//
// The bonus term is one dot a step: sum_i r_i u_i k_i v_j = v_j d with
// d = sum_i r_i u_i k_i, so y[t, j] = sum_i r_i s[i, j] + v_j d.
//
// What bounds it.  At the prefill shape (B = 8, S = 2048, H = 40, K = 64,
// bf16 r, k, v): the bytes are r, k, v (3 x 83.9 MB), w and y
// (2 x 167.8 MB) and the state in and out (2 x 5.2 MB), 597.7 MB, 0.178
// ms at 3.35 TB/s; the operations are 5 f32 flops a state element a step
// (r s: 2; k v: 1; w s + k v: 2) and 5 a (step, head, j) (d: 3 a term;
// v_j d added: 2), 13.63 GFLOP, 0.203 ms at 67 TFLOP/s.  Operations bound
// it, on the CUDA cores.  At S = 1 (a decode step) the state's bytes bound
// it (10.5 MB, 3.1 us).
//
// Design (simple first): one block per (b, h), K threads; thread j owns
// column j of the state in K registers, so the recurrence needs no
// exchange between threads.  CHUNK steps of r, k, w, v and r u k are
// staged in shared memory at a time; each step's d is summed by one
// thread, in index order, from a padded row (conflict-free); three
// barriers a chunk, not a step.  Each thread then walks the chunk's steps,
// reading a step's r_i, k_i and w_i as float4 broadcasts.  The y sum runs
// in four partial sums (another summation order than a plain loop: f32
// roundoff); every step's arithmetic is the same wherever the chunks cut
// the sequence, so a run split in two with the state carried gives the
// whole run's bits.  What limits
// it: B·H blocks of K threads, a few warps an SM (320 blocks of 64 threads
// at B = 8; only 40 at B = 1), so each step's dependent FMAs and shared
// loads are latency-bound, not throughput-bound.
//
// C interface (no PyTorch headers, bound with ctypes): launches on the
// given stream and returns a CUDA error code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 32;  // steps staged in shared memory at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// one state element (i, j) of one step: y's term from the old state, then
// the decay and the new k v
__device__ __forceinline__ void element(float& s, float& acc, float ri,
                                        float ki, float wi, float vj) {
  acc = fmaf(ri, s, acc);
  s = fmaf(wi, s, ki * vj);
}

template <typename T, int K>
__global__ void __launch_bounds__(K)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* s_in,
                float* __restrict__ y, float* s_out, int S, int H) {
  __shared__ __align__(16) float rs[CHUNK][K];
  __shared__ __align__(16) float ks[CHUNK][K];
  __shared__ __align__(16) float ws[CHUNK][K];
  __shared__ float vs[CHUNK][K];
  __shared__ float ruk[CHUNK][K + 1];  // r_i u_i k_i; a row's pad: no conflict
  __shared__ float ds[CHUNK];          // d of each step

  const int bh = blockIdx.x;  // b * H + h
  const int h = bh % H;
  const int b = bh / H;
  const int j = threadIdx.x;

  float st[K];
  const float* sp = s_in + static_cast<long long>(bh) * K * K + j;
#pragma unroll
  for (int i = 0; i < K; ++i) st[i] = sp[i * K];
  const float uj = u[h * K + j];

  const long long row = static_cast<long long>(H) * K;  // one step
  const long long base = static_cast<long long>(b) * S * row +
                         static_cast<long long>(h) * K + j;
  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const int n = min(CHUNK, S - t0);
    __syncthreads();  // the previous chunk's reads are done
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const long long off = base + static_cast<long long>(t0 + c) * row;
      const float kk = to_f32(k[off]);
      const float rr = to_f32(r[off]);
      rs[c][j] = rr;
      ks[c][j] = kk;
      ws[c][j] = w[off];
      vs[c][j] = to_f32(v[off]);
      ruk[c][j] = rr * (uj * kk);
    }
    __syncthreads();
    for (int c = j; c < n; c += K) {  // one thread a step's d
      float d = 0.f;
#pragma unroll 8
      for (int i = 0; i < K; ++i) d += ruk[c][i];
      ds[c] = d;
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = vs[c][j];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
      for (int i = 0; i < K; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[c][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[c][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[c][i]);
        element(st[i + 0], acc0, r4.x, k4.x, w4.x, vj);
        element(st[i + 1], acc1, r4.y, k4.y, w4.y, vj);
        element(st[i + 2], acc2, r4.z, k4.z, w4.z, vj);
        element(st[i + 3], acc3, r4.w, k4.w, w4.w, vj);
      }
      y[base + static_cast<long long>(t0 + c) * row] =
          fmaf(vj, ds[c], (acc0 + acc1) + (acc2 + acc3));
    }
  }
  float* so = s_out + static_cast<long long>(bh) * K * K + j;
#pragma unroll
  for (int i = 0; i < K; ++i) so[i * K] = st[i];
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s_in, void* y, void* s_out, int B,
           int S, int H, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(B) * H;
  wkv6_kernel<T, K><<<static_cast<unsigned>(blocks), K, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s_in),
      static_cast<float*>(y), static_cast<float*>(s_out), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s_in, void* y, void* s_out, int B,
             int S, int H, int K, cudaStream_t stream) {
  switch (K) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, s_in, y, s_out, B, S, H, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s_in, y, s_out, B, S, H, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 for f32 r, k, v; 1 for bf16
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s_in,
                        void* y, void* s_out, int B, int S, int H, int K,
                        int dtype, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || static_cast<long long>(B) * H > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, u, s_in, y, s_out, B, S, H, K, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s_in, y, s_out, B, S, H, K,
                                   stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
