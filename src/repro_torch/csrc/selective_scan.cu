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
// Under autograd the forward also writes the state at every CKPT-th step
// (the state entering steps 0, CKPT, 2 CKPT, ...) into a buffer (B,
// ceil(S / CKPT), DI, DS) f32: the kernel's form of the reference's
// chunked remat of the time scan (mamba.chunked_time_scan, chunks of 256
// steps there).  CKPT = 16 divides the staging chunk, so a checkpoint
// falls on a staged step; the store sits beside the arithmetic, and y and
// the final state are those of the forward without it, bit for bit.  At
// the training shape (B = 8, S = 512, DI = 16384, DS = 16) it keeps 32
// states of 8.4 MB, 268 MB a layer; with remat one layer's at a time.
//
// The backward, selective_scan_bwd_kernel.  With e_t = exp(dt_t a) (one
// value a state element), g_t the gradient reaching the state h_t, walked
// from t = S - 1 down to 0 with g_S's share e_S g_S replaced by dS, the
// final state's gradient (zero where it is not used):
//
//   g_t      = dy_t C_t + e_{t+1} g_{t+1}
//   dC_t[s]  = sum_d dy_t[d] h_t[d, s]
//   dB_t[s]  = sum_d g_t[d, s] dt_t[d] x_t[d]
//   d(dt_t)  = sum_s g_t[s] (a[s] e_t[s] h_{t-1}[s] + x_t B_t[s])
//   dx_t     = dt_t sum_s g_t[s] B_t[s] + dy_t D
//   dA_log   = a sum_{b,t} g_t dt_t e_t h_{t-1}
//   dD       = sum_{b,t} dy_t x_t
//   dh0      = e_0 g_0
//
// (h_{-1} = h0).  g needs no forward state; dC, d(dt) and dA_log need the
// states, which are recomputed from the chunk's checkpoint with the
// forward's arithmetic (so they are the forward's bits), never recovered
// as (h_t - dt x B) / e: e underflows to 0 in f32.
//
// Design (simple first): a thread owns one (b, d) channel, as in the
// forward: its DS values of g, a, a log2 e and dA_log's sum in registers.
// A block of BCH = 64 channels of one row walks the chunks of CKPT steps
// from the last.  For each it stages the chunk's B and C rows in shared
// memory, recomputes the states entering its steps from the checkpoint
// into shared memory (CKPT x DS x BCH f32, 64 KiB at DS = 16, a thread's
// values at stride BCH: no bank conflict), then walks the chunk backward,
// h_t recomputed from h_{t-1} with the forward's fma.  dB and dC are sums
// over all channels for each (b, t, s): a step's 2 DS terms of a warp are
// summed by a reduce-scatter of shuffles (each lane ends with one sum, 31
// shuffles at DS = 16), the warps' sums kept in shared memory for the
// chunk and added, in warp order, once a chunk: one partial a block,
// (B, S, DI / BCH, DS), summed over the blocks by the wrapper (torch.sum).
// dA_log and dD are summed over t in registers and written per row b,
// summed over b by the wrapper.  No atomics: the same inputs give the
// same bits.  dx is written in f32 (the wrapper casts it).
//
// What bounds the backward: at B = 8, S = 512, DI = 16384, DS = 16 its
// work is 1.074e9 state-element steps, each one exp (e_t) and 16 f32
// flops (dt a: 1; g: 2; its decay: 1; dC's and dB's terms: 2 each; g B:
// 2; g e h: 2; dA's sum: 2; d(dt)'s: 2), and 8 flops a (step, channel)
// (dt x: 1; d(dt): 2; dx: 3; dD: 2): 17.7 GFLOP, 0.264 ms at 67 TFLOP/s,
// beside 1.074e9 exps (0.257 ms on the SFU alone at 1.98 GHz); its bytes,
// dt, dy, d(dt) in f32, x and dx in bf16, B, C, dB, dC, the states, 1.10
// GB, 0.329 ms at 3.35 TB/s.  Bytes bound it.  The kernel does more: the
// recompute's exp and fma a state element, the reduction's shuffles, and
// only 6 warps an SM (3 blocks of 2 warps, the states' shared memory).
//
// C interface (no PyTorch headers, bound with ctypes): launches on the
// given stream and returns a CUDA error code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 128;     // channels a block of the forward, one a thread
constexpr int CHUNK = 64;   // steps whose B and C rows are staged at a time
constexpr int CKPT = 16;    // steps between two checkpoints of the state
constexpr int BCH = 64;     // channels a block of the backward, one a thread
constexpr int BWARPS = BCH / 32;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(CHUNK % CKPT == 0, "a checkpoint falls on a step of a staged chunk");

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

// KEEP: write the checkpoints (a template parameter, so that the forward
// without them is the same code as before they existed)
template <typename T, int DS, bool KEEP>
__global__ void __launch_bounds__(CH)
    selective_scan_kernel(const float* __restrict__ dt, const T* __restrict__ x,
                          const float* __restrict__ bm, const float* __restrict__ cm,
                          const float* __restrict__ a_log,
                          const float* __restrict__ dskip, const float* h_in,
                          float* __restrict__ y, float* h_out,
                          float* __restrict__ ck, int S, int DI) {
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

  const int nck = (S + CKPT - 1) / CKPT;
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
      if (KEEP && c % CKPT == 0) {  // the state entering step t0 + c
        float4* cp = reinterpret_cast<float4*>(
            ck + ((static_cast<long long>(b) * nck + (t0 + c) / CKPT) * DI + d) * DS);
#pragma unroll
        for (int s = 0; s < DS; s += 4) cp[s / 4] = make_float4(h[s], h[s + 1], h[s + 2], h[s + 3]);
      }
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

// A warp's sum of each of N values a lane, scattered: at each level the
// lanes with bit M set keep the upper half of their values and add their
// partner's, the others the lower half; with one value left, the lanes
// that hold the same one add theirs by a butterfly.  Lane l ends with the
// sum of value l >> (5 - log2 N), in a fixed order.
template <int N, int M>
struct Scatter {
  __device__ __forceinline__ static void run(float* v, int lane) {
    const bool up = (lane & M) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float keep = up ? v[N / 2 + i] : v[i];
      const float send = up ? v[i] : v[N / 2 + i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    Scatter<N / 2, M / 2>::run(v, lane);
  }
};

template <int M>
struct Scatter<1, M> {
  __device__ __forceinline__ static void run(float* v, int) {
#pragma unroll
    for (int m = M; m >= 1; m /= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
  }
};

__host__ __device__ constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

// the backward's pointers, in the C entry point's order
struct Grads {
  const void *dt, *x, *bm, *cm, *a_log, *dskip, *ck, *dy, *dh_in;
  void *ddt, *dx, *db_part, *dc_part, *da_part, *dd_part, *dh0;
};

template <int DS>
constexpr int bwd_smem_bytes() { return CKPT * DS * BCH * static_cast<int>(sizeof(float)); }

template <typename T, int DS>
__global__ void __launch_bounds__(BCH)
    selective_scan_bwd_kernel(const float* __restrict__ dt, const T* __restrict__ x,
                              const float* __restrict__ bm, const float* __restrict__ cm,
                              const float* __restrict__ a_log,
                              const float* __restrict__ dskip,
                              const float* __restrict__ ck, const float* __restrict__ dy,
                              const float* __restrict__ dh_in, float* __restrict__ ddt,
                              float* __restrict__ dx, float* __restrict__ db_part,
                              float* __restrict__ dc_part, float* __restrict__ da_part,
                              float* __restrict__ dd_part, float* __restrict__ dh0, int S,
                              int DI) {
  constexpr int V = 2 * DS;  // a step's terms of dB and dC a channel
  static_assert(V <= 32 && (V & (V - 1)) == 0, "a warp scatters 2 DS sums");
  constexpr int SHIFT = 5 - log2i(V);  // lane l holds the sum of value l >> SHIFT
  // the states entering the chunk's steps, [c][s][thread]
  extern __shared__ __align__(16) float st[];
  __shared__ __align__(16) float bs[CKPT][DS];
  __shared__ __align__(16) float cs[CKPT][DS];
  __shared__ float red[CKPT][BWARPS][V];  // each warp's sums of a step's terms

  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = blk * BCH + tid;
  const bool live = d < DI;

  float a[DS], a2[DS], g[DS], da[DS];
  const long long state = (static_cast<long long>(b) * DI + d) * DS;
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    // a2 as the forward computes it, so that the recomputed states are its
    a[s] = live ? -expf(a_log[static_cast<long long>(d) * DS + s]) : 0.f;
    a2[s] = a[s] * LOG2E;
    // e_{t+1} g_{t+1}: what reaches h_t from the step after; dS at the end
    g[s] = live && dh_in != nullptr ? dh_in[state + s] : 0.f;
    da[s] = 0.f;
  }
  const float dskv = live ? dskip[d] : 0.f;
  float dd = 0.f;

  const int nck = (S + CKPT - 1) / CKPT;
  const long long row0 = static_cast<long long>(b) * S;  // (b, t = 0)
  for (int c0 = nck - 1; c0 >= 0; --c0) {
    const int t0 = c0 * CKPT;
    const int n = min(CKPT, S - t0);
    __syncthreads();  // the previous chunk's reads of bs, cs, st and red are done
    const long long src = (row0 + t0) * DS;
    for (int i = tid; i < n * DS; i += BCH) {
      (&bs[0][0])[i] = bm[src + i];
      (&cs[0][0])[i] = cm[src + i];
    }
    __syncthreads();
    const long long base = (row0 + t0) * DI + d;
    {  // the states entering steps t0 .. t0 + n - 1, from the checkpoint
      float h[DS];
      const float4* cp = reinterpret_cast<const float4*>(
          ck + ((static_cast<long long>(b) * nck + c0) * DI + d) * DS);
#pragma unroll
      for (int s = 0; s < DS; s += 4) {
        const float4 q = live ? cp[s / 4] : make_float4(0.f, 0.f, 0.f, 0.f);
        h[s] = q.x, h[s + 1] = q.y, h[s + 2] = q.z, h[s + 3] = q.w;
      }
      for (int c = 0; c < n; ++c) {
#pragma unroll
        for (int s = 0; s < DS; ++s) st[(c * DS + s) * BCH + tid] = h[s];
        if (c + 1 == n) break;
        const long long off = base + static_cast<long long>(c) * DI;
        const float dtv = live ? dt[off] : 0.f;
        const float dtx = dtv * (live ? to_f32(x[off]) : 0.f);
#pragma unroll
        for (int s = 0; s < DS; s += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(&bs[c][s]);
          h[s + 0] = fmaf(ex2(dtv * a2[s + 0]), h[s + 0], dtx * b4.x);
          h[s + 1] = fmaf(ex2(dtv * a2[s + 1]), h[s + 1], dtx * b4.y);
          h[s + 2] = fmaf(ex2(dtv * a2[s + 2]), h[s + 2], dtx * b4.z);
          h[s + 3] = fmaf(ex2(dtv * a2[s + 3]), h[s + 3], dtx * b4.w);
        }
      }
    }
    for (int c = n - 1; c >= 0; --c) {
      const long long off = base + static_cast<long long>(c) * DI;
      const float dtv = live ? dt[off] : 0.f;
      const float xv = live ? to_f32(x[off]) : 0.f;
      const float dyv = live ? dy[off] : 0.f;
      const float dtx = dtv * xv;
      float v[V];  // dB's terms, then dC's
      float gb = 0.f, ddt_a = 0.f;
#pragma unroll
      for (int s = 0; s < DS; s += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&bs[c][s]);
        const float4 c4 = *reinterpret_cast<const float4*>(&cs[c][s]);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int q = s + k;
          const float hp = st[(c * DS + q) * BCH + tid];  // h_{t-1}
          const float e = ex2(dtv * a2[q]);
          const float hc = fmaf(e, hp, dtx * bv[k]);  // h_t, the forward's bits
          const float gs = fmaf(dyv, cv[k], g[q]);    // g_t
          v[DS + q] = dyv * hc;
          v[q] = gs * dtx;
          gb = fmaf(gs, bv[k], gb);
          const float w = gs * (e * hp);
          da[q] = fmaf(w, dtv, da[q]);
          ddt_a = fmaf(w, a[q], ddt_a);
          g[q] = gs * e;
        }
      }
      if (live) {
        ddt[off] = fmaf(xv, gb, ddt_a);
        dx[off] = fmaf(dtv, gb, dyv * dskv);
      }
      dd = fmaf(dyv, xv, dd);
      Scatter<V, 16>::run(v, lane);
      if ((lane & ((1 << SHIFT) - 1)) == 0) red[c][warp][lane >> SHIFT] = v[0];
    }
    __syncthreads();  // every warp's sums of the chunk are in red
    const int nblk = gridDim.x;
    for (int i = tid; i < n * V; i += BCH) {
      const int c = i / V, j = i % V;
      float sum = red[c][0][j];
#pragma unroll
      for (int w = 1; w < BWARPS; ++w) sum += red[c][w][j];
      float* out = j < DS ? db_part : dc_part;
      out[((row0 + t0 + c) * nblk + blk) * DS + j % DS] = sum;
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      dh0[state + s] = g[s];
      da_part[state + s] = a[s] * da[s];
    }
    dd_part[static_cast<long long>(b) * DI + d] = dd;
  }
}

template <typename T, int DS>
int launch(const void* dt, const void* x, const void* bm, const void* cm,
           const void* a_log, const void* dskip, const void* h_in, void* y,
           void* h_out, void* ck, int B, int S, int DI, cudaStream_t stream) {
  const dim3 grid((DI + CH - 1) / CH, B);
  auto kernel = ck != nullptr ? selective_scan_kernel<T, DS, true>
                              : selective_scan_kernel<T, DS, false>;
  kernel<<<grid, CH, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a_log), static_cast<const float*>(dskip),
      static_cast<const float*>(h_in), static_cast<float*>(y),
      static_cast<float*>(h_out), static_cast<float*>(ck), S, DI);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* dt, const void* x, const void* bm, const void* cm,
             const void* a_log, const void* dskip, const void* h_in, void* y,
             void* h_out, void* ck, int B, int S, int DI, int DS, cudaStream_t stream) {
  switch (DS) {
    case 8:
      return launch<T, 8>(dt, x, bm, cm, a_log, dskip, h_in, y, h_out, ck, B, S, DI,
                          stream);
    case 16:
      return launch<T, 16>(dt, x, bm, cm, a_log, dskip, h_in, y, h_out, ck, B, S, DI,
                           stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int DS>
int launch_bwd(const Grads& a, int B, int S, int DI, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<DS>();
  const cudaError_t set = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<T, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((DI + BCH - 1) / BCH, B);
  selective_scan_bwd_kernel<T, DS><<<grid, BCH, smem, stream>>>(
      static_cast<const float*>(a.dt), static_cast<const T*>(a.x),
      static_cast<const float*>(a.bm), static_cast<const float*>(a.cm),
      static_cast<const float*>(a.a_log), static_cast<const float*>(a.dskip),
      static_cast<const float*>(a.ck), static_cast<const float*>(a.dy),
      static_cast<const float*>(a.dh_in), static_cast<float*>(a.ddt),
      static_cast<float*>(a.dx), static_cast<float*>(a.db_part),
      static_cast<float*>(a.dc_part), static_cast<float*>(a.da_part),
      static_cast<float*>(a.dd_part), static_cast<float*>(a.dh0), S, DI);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(const Grads& a, int B, int S, int DI, int DS, cudaStream_t stream) {
  switch (DS) {
    case 8:
      return launch_bwd<T, 8>(a, B, S, DI, stream);
    case 16:
      return launch_bwd<T, 16>(a, B, S, DI, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_sizes(int B, int S, int DI, int ck_steps) {
  return B <= 0 || B > 65535 || S <= 0 || DI <= 0 || ck_steps != CKPT;
}

}  // namespace

// dtype: 0 for f32 x; 1 for bf16.  B rows at most 65535 (the grid's y).
// ck: the checkpoints' buffer (B, ceil(S / ck_steps), DI, DS), or null for
// none; ck_steps must be CKPT
extern "C" int selective_scan_fwd(const void* dt, const void* x, const void* bm,
                                  const void* cm, const void* a_log, const void* dskip,
                                  const void* h_in, void* y, void* h_out, void* ck, int B,
                                  int S, int DI, int DS, int ck_steps, int dtype,
                                  cudaStream_t stream) {
  if (bad_sizes(B, S, DI, ck_steps)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(dt, x, bm, cm, a_log, dskip, h_in, y, h_out, ck, B, S, DI, DS,
                           stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(dt, x, bm, cm, a_log, dskip, h_in, y, h_out, ck, B, S,
                                   DI, DS, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the backward: dh_in (B, DI, DS) or null for a zero dS; ddt, dx (B, S,
// DI) f32; db_part, dc_part (B, S, ceil(DI / channels), DS) the partial
// sums of a block of channels (channels must be BCH); da_part (B, DI, DS)
// and dd_part (B, DI) those of each row; dh0 (B, DI, DS)
extern "C" int selective_scan_bwd(const void* dt, const void* x, const void* bm,
                                  const void* cm, const void* a_log, const void* dskip,
                                  const void* ck, const void* dy, const void* dh_in,
                                  void* ddt, void* dx, void* db_part, void* dc_part,
                                  void* da_part, void* dd_part, void* dh0, int B, int S,
                                  int DI, int DS, int ck_steps, int channels,
                                  int dtype, cudaStream_t stream) {
  if (bad_sizes(B, S, DI, ck_steps) || channels != BCH)
    return static_cast<int>(cudaErrorInvalidValue);
  const Grads a{dt, x, bm, cm, a_log, dskip, ck, dy, dh_in,
                ddt, dx, db_part, dc_part, da_part, dd_part, dh0};
  if (dtype == 0) return dispatch_bwd<float>(a, B, S, DI, DS, stream);
  if (dtype == 1) return dispatch_bwd<__nv_bfloat16>(a, B, S, DI, DS, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
